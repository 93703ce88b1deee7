"""A/B harness of the FAST-score variants T1-T4 on the card.

    python -m orbslam3_tpu_torch.tools.bench_fast_variants

Runs the case lists of the four TPU harnesses (``tools/bench_fast_variants.py``
:109-116, ``bench_fast_variants2.py``:171-180, ``bench_fast_variants3.py``
:137-143, ``bench_fast_variants4.py``:122-128), each case mapped to its
meaning on the card (``ops/fast_variants.py``), on two images: the
harnesses' own 2112x736 u8 image from ``np.random.default_rng(0)``, and
the stereo detection composite (3264x736: both cameras' pyramid crops of
a 752x480 synthetic stereo pair, 8 levels, as the stereo front-end packs
them).  For each case it checks the kernel against the plain version bit
for bit (the check pass: one launch of each case, the launches counted),
after a line per kernel instantiation from ``-Xptxas -v`` (registers,
spills), then prints the kernel's device time (a CUDA graph of 20 calls timed with
events) beside B1's (``csrc/fast_score.cu``) on the same image, and the
bound of the function (``utils/device_time.FAST_SCORE_OPS_PER_PX``, the
same for every case).  The last line is a JSON list of the results.  Needs
a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from orbslam3_tpu_torch.ops import fast_variants as fv
from orbslam3_tpu_torch.utils.device_time import (
    FAST_SCORE_OPS_PER_PX,
    INT16X2_OPS_PER_S,
    bound_ms,
    device_ms,
)

HARNESS_HW = (2112, 736)

# (label, arguments of the wrapper after the image), as the TPU harnesses list them
CASES = {
    "t1": [
        ("current", (False, None, None)),
        ("cast-early", (True, None, None)),
        ("i32-views", (False, None, torch.int32)),
        ("bf16-chains", (False, torch.bfloat16, None)),
        ("i32v+bf16chain", (False, torch.bfloat16, torch.int32)),
        ("bf16-everything", (True, None, torch.bfloat16)),
    ],
    "t2": [
        ("strip32 logstep", (32,)),
        ("strip32 vanherk", (32, fv.VANHERK)),
        ("strip16 logstep", (16,)),
        ("strip16 vanherk", (16, fv.VANHERK)),
        ("strip32 chunk16x256", (32, fv.LOGSTEP, (16, 256))),
        ("strip32 chunk16x256v", (32, fv.VANHERK, (16, 256))),
        ("strip32 chunk16x384v", (32, fv.VANHERK, (16, 384))),
        ("strip32 chunk32x256v", (32, fv.VANHERK, (32, 256))),
    ],
    "t3": [
        ("twopass s48 c384", (48, 384, "twopass")),
        ("twopass s48 c768", (48, 768, "twopass")),
        ("twopass s48 c192", (48, 192, "twopass")),
        ("twopass s64 c384", (64, 384, "twopass")),
        ("onepass s48 c384 (ctrl)", (48, 384, "onepass")),
    ],
    "t4": [
        ("vanherk s48 c384 (ctrl)", (48, 384, fv.VANHERK)),
        ("pairs s48 c384", (48, 384, fv.PAIRS)),
        ("pairs s48 c192", (48, 192, fv.PAIRS)),
        ("pairs s48 c768", (48, 768, fv.PAIRS)),
        ("pairs s32 c384", (32, 384, fv.PAIRS)),
    ],
}

# kernel wrapper, plain version and parameter mapping of each TPU function
FUNCTIONS = {
    "t1": (fv.fast_variant_t1, fv.fast_variant_t1_plain, fv.t1_variant),
    "t2": (fv.fast_variant_t2, fv.fast_variant_t2_plain, fv.t2_variant),
    "t3": (fv.fast_variant_t3, fv.fast_variant_t3_plain, fv.t3_variant),
    "t4": (fv.fast_variant_t4, fv.fast_variant_t4_plain, fv.t4_variant),
}


def harness_image() -> np.ndarray:
    """The TPU harnesses' image (e.g. tools/bench_fast_variants.py:17-19)."""
    return np.random.default_rng(0).integers(0, 256, HARNESS_HW, np.uint8)


def stereo_detection_composite(device) -> torch.Tensor:
    """The stereo front-end's detection composite of frame 0 of the
    synthetic 752x480 stereo sequence (seed 1), at the default
    PyramidParams: (3264, 736) u8."""
    from orbslam3_tpu_torch import Pinhole, PyramidParams, stereo_sequence
    from orbslam3_tpu_torch.frontend import stereo_frame as sf
    from orbslam3_tpu_torch.ops import extractor as ex
    from orbslam3_tpu_torch.ops import fast, pyramid

    h, w, fx = 480, 752, 435.2
    params = PyramidParams()
    img_l, img_r, _ = stereo_sequence(1, Pinhole([fx, fx, w / 2, h / 2]), 0.11, h, w, seed=1)[0]
    fe = sf.front_end(params, (h, w), fx * 0.11, fx, str(device))
    pair = torch.from_numpy(np.stack([img_l, img_r])).to(device)
    pyrs = [pyramid.build_pyramid(pair[i], params, fe.resize_taps()) for i in range(2)]
    crops = [c for p in pyrs for c in ex.detection_crops(p, params)[1]]
    return fast.detection_composite(crops)[0]


def score_bound_ms(shape) -> tuple:
    """(ms, bound_by) of the function on an image of `shape`, whichever
    variant computes it: 1 B read and 4 B written per pixel, and
    FAST_SCORE_OPS_PER_PX operations per pixel in 16-bit lanes."""
    n = shape[0] * shape[1]
    return bound_ms(5 * n, n * FAST_SCORE_OPS_PER_PX, INT16X2_OPS_PER_S)


def check(images: dict, cases: dict = CASES, log=print) -> list:
    """The check pass: every case of `cases` on every image of `images`
    (name -> (h, w) u8 CUDA tensor), one kernel call against the plain
    version.  Each case launches its kernel once."""
    results = []
    for image_name, img in images.items():
        for fn_name, fn_cases in cases.items():
            wrapper, plain, mapping = FUNCTIONS[fn_name]
            for label, args in fn_cases:
                got, want = wrapper(img, *args), plain(img, *args)
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
                log(f"  {image_name} {tuple(img.shape)} {fn_name} {label:24s} "
                    f"{'exact' if err == 0 else f'ERR {err}'}; {mapping(*args)}")
                results.append(dict(image=image_name, shape=list(img.shape), function=fn_name,
                                    case=label, args=args, max_abs_err=err))
    return results


def time_cases(images: dict, results: list, log=print) -> None:
    """The timing pass: adds each checked case's device time, B1's on the
    same image and the bound to its entry of `results`."""
    from orbslam3_tpu_torch.ops.fast import raw_score_map

    for image_name, img in images.items():
        b1_ms = device_ms(lambda: raw_score_map(img))
        bound, bound_by = score_bound_ms(img.shape)
        log(f"{image_name} {tuple(img.shape)}: B1 {b1_ms:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by})")
        for r in results:
            if r["image"] != image_name:
                continue
            wrapper, args = FUNCTIONS[r["function"]][0], r["args"]
            ms = device_ms(lambda: wrapper(img, *args))
            log(f"  {r['function']} {r['case']:24s} {ms:.4f} ms, {ms / b1_ms:.2f}x B1, "
                f"roofline share {bound / ms:.2f}")
            r.update(ms=ms, b1_ms=b1_ms, bound_ms=bound, bound_by=bound_by)


def run(images: dict, cases: dict = CASES, log=print) -> list:
    """The check pass, then the timing pass."""
    results = check(images, cases, log)
    time_cases(images, results, log)
    return results


def ptxas_summary() -> list:
    """One line per instantiation of the T1-T4 kernel: its template
    arguments (reducer, passes, packed) as mangled, and what `-Xptxas -v`
    said of its stack, spills and registers.  Builds the kernel library
    first; empty when it was built already in an earlier process."""
    from orbslam3_tpu_torch import _build

    _build.kernels()
    out, name = [], None
    for line in _build.build_info["log"].splitlines():
        if "Compiling entry" in line:
            name = line.split("fast_variant_kernel")[1].split("EE")[0] if "fast_variant_kernel" in line else None
        elif name and ("spill" in line or "registers" in line):
            out.append(f"ptxas {name}: {line.split(': ')[-1].strip()}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_fast_variants: torch.cuda.is_available() is False; this harness needs "
              "a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    for line in ptxas_summary():
        print(line, flush=True)
    images = {
        "harness": torch.from_numpy(harness_image()).to(dev),
        "stereo composite": stereo_detection_composite(dev),
    }
    results = run(images, log=lambda s: print(s, flush=True))
    print(json.dumps([{k: v for k, v in r.items() if k != "args"} for r in results]))
    return 0 if all(r["max_abs_err"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
