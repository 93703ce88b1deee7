"""Check and time B1 and B3, the two FAST-score kernels, on the card.

    python -m orbslam3_tpu_torch.tools.bench_score_kernels [--reps N]

Builds the kernels of the tree it is run from, holds B1 (``fast.raw_score_map``)
and B3 (``fast.detect_fused``) bit for bit against their plain versions on
the main path's detection composites (752x480 synthetic stereo pair, 8
levels: 3264x736 for both cameras, 1632x736 for one) and on the images and
thresholds of ``tools/score_extremes.py``, then times B1 on the stereo
composite and B3 on the mono composite (device time of a CUDA graph of 20
calls, ``utils/device_time.device_ms``) N times each.  For an A/B of two
trees, run it from each on the same card, alternating (parent, change,
change, parent).  The last line is a JSON object; ``exact`` lists every
check.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

H, W, FX, BASELINE, SEED = 480, 752, 435.2, 0.11, 1


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.is_cuda:
        torch.cuda.synchronize()
    return float((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def b1_extreme_errs(dev) -> dict:
    """{case: max abs err} of B1 against its plain version on every image
    of tools/score_extremes.py, with the seam mask and without."""
    from orbslam3_tpu_torch.ops import fast
    from orbslam3_tpu_torch.tools import score_extremes as se

    errs = {}
    for name, arr in se.score_images().items():
        img = torch.from_numpy(arr).to(dev)
        for m in (None, torch.from_numpy(se.seam_mask(*arr.shape)).to(dev)):
            errs[f"B1 {name} {tuple(arr.shape)} mask={m is not None}"] = _err(
                fast.raw_score_map(img, m), fast.raw_score_map_plain(img, m))
    return errs


def b3_extreme_errs(dev, composites: dict) -> dict:
    """{case: max abs err} of B3 against its plain version at the
    thresholds of tools/score_extremes.py on its images, and at min_th <= 0
    and ini_th > 254 on `composites` (label -> (comp, mask) on `dev`)."""
    from orbslam3_tpu_torch.ops import fast
    from orbslam3_tpu_torch.tools import score_extremes as se

    cases = [(f"{kind} 64x96", *(torch.from_numpy(a).to(dev) for a in se.b3_case(kind)), ini, mn)
             for kind, ini, mn in se.B3_THRESHOLDS]
    cases += [(label, comp, m, ini, mn) for label, (comp, m) in composites.items()
              for ini, mn in ((20, 0), (20, -5), (300, -300))]
    return {f"B3 {label} {ini}/{mn}": _err(fast.detect_fused(comp, m, ini, mn),
                                           fast.detect_fused_plain(comp, m, ini, mn))
            for label, comp, m, ini, mn in cases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2, help="timings of each kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_score_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    import orbslam3_tpu_torch as port
    from orbslam3_tpu_torch import _build
    from orbslam3_tpu_torch.frontend import stereo_frame as sf
    from orbslam3_tpu_torch.ops import extractor as ex, fast, pyramid
    from orbslam3_tpu_torch.utils.device_time import device_ms

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.kernels()
    build_s = time.perf_counter() - t0
    camera = port.Pinhole([FX, FX, W / 2, H / 2])
    frames = port.stereo_sequence(1, camera, BASELINE, H, W, seed=SEED)
    params = port.PyramidParams()
    fe = sf.front_end(params, (H, W), FX * BASELINE, FX, "cuda")
    pair = torch.from_numpy(np.stack(frames[0][:2])).to(dev)
    pyrs = [pyramid.build_pyramid(pair[i], params, fe.resize_taps()) for i in range(2)]
    comp, _, _ = fast.detection_composite([c for p in pyrs for c in ex.detection_crops(p, params)[1]])
    fe_mono = ex.feature_extractor(params, (H, W), port.FusedKernels(), "cuda")
    mono_pyr = pyramid.build_pyramid(pair[0], params, fe_mono.resize_taps())
    mono_comp, _, _ = fast.detection_composite(ex.detection_crops(mono_pyr, params)[1])

    ini, mn = params.ini_th_fast, params.min_th_fast
    errs = {"B1 stereo composite": _err(fast.raw_score_map(comp, fe.det_mask),
                                        fast.raw_score_map_plain(comp, fe.det_mask)),
            "B3 mono composite": _err(fast.detect_fused(mono_comp, fe_mono.det_mask, ini, mn),
                                      fast.detect_fused_plain(mono_comp, fe_mono.det_mask, ini, mn)),
            **b1_extreme_errs(dev),
            **b3_extreme_errs(dev, {"mono composite": (mono_comp, fe_mono.det_mask),
                                    "stereo composite": (comp, fe.det_mask)})}
    b1_ms = [device_ms(lambda: fast.raw_score_map(comp, fe.det_mask)) for _ in range(args.reps)]
    b3_ms = [device_ms(lambda: fast.detect_fused(mono_comp, fe_mono.det_mask, ini, mn))
             for _ in range(args.reps)]
    for label, ms in (("B1", b1_ms), ("B3", b3_ms)):
        print(f"{label} device ms: {' '.join(f'{t:.5f}' for t in ms)}")
    exact = {k: e == 0 for k, e in errs.items()}
    print(f"bit-exact: {sum(exact.values())} of {len(exact)} checks")
    print(json.dumps(dict(build_s=build_s, b1_shape=list(comp.shape), b1_ms=b1_ms,
                          b3_shape=list(mono_comp.shape), b3_ms=b3_ms, exact=exact)))
    return 0 if all(exact.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
