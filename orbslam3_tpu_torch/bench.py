"""Driver benchmark of the port: steady-state ORB extraction + stereo
matching latency of one frame on the card.

    python -m orbslam3_tpu_torch.bench [--frames N] [--warmup N] [--batch B]

Prints ONE final JSON line:
  {"metric": "stereo_orb_extract_match_ms_per_frame", "value": N,
   "unit": "ms", "vs_baseline": N}

Baseline: the reference's measured 38.53 ms/frame ORB extraction on EuRoC
MH01 stereo (ExecMean.txt:6, see BASELINE.md); `vs_baseline` is
38.53 / value (> 1 means faster), the reference bench's own formula.

Input: stereo pairs made by `make_frame` (two 752x480 frames each), 8
levels, 1000 features a camera, on the card before timing starts.  The
headline is the median host wall of one frame's front-end
(`StereoFrontEnd.forward`: one replay of the front-end's CUDA graph, what
users get) plus the copy of its (K, 40) block to the host, after warm-up
(the first call captures the graph), the card synchronised before each
frame.  Earlier lines carry the stream window of the same calls between
CUDA events (the copy excluded), the stream window of the same program
run op by op (`StereoFrontEnd.eager`) on the same pairs, the
batched-throughput figure per frame (`StereoFrontEnd.batch` over B pairs
plus one copy, divided by B), and the reference GPU fork's extraction +
stereo matching (38.53 + 7.74 ms) beside the headline.  With no card, or
on any failure, the final line carries "value": null and the exit code
is not 0.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

BASELINE_EXTRACT_MS = 38.53  # reference ExecMean.txt:6
BASELINE_MATCH_MS = 7.74  # reference ExecMean.txt:7
HEADLINE_METRIC = "stereo_orb_extract_match_ms_per_frame"
H, W = 480, 752


def make_frame(seed: int, h: int = H, w: int = W) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (
        120 + 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0) + rng.normal(0, 18, (h, w))
    ).clip(0, 255)
    for _ in range(120):
        cx, cy = int(rng.integers(20, w - 20)), int(rng.integers(20, h - 20))
        r = int(rng.integers(3, 14))
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = int(rng.integers(0, 256))
    return img.astype(np.uint8)


def measure(n_frames: int = 64, warmup: int = 5, batch: int = 8) -> dict:
    """The bench's figures (ms) over `n_frames` distinct pairs on the
    card, after `warmup` frames; raises without one."""
    from orbslam3_tpu_torch._device import resolve_device
    from orbslam3_tpu_torch.frontend import stereo_frame as sf
    from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams
    from orbslam3_tpu_torch.utils.device_time import window_ms

    dev = resolve_device("cuda")
    params = PyramidParams(n_features=1000)
    pairs = torch.from_numpy(np.stack([
        np.stack([make_frame(2 * i), make_frame(2 * i + 1)]) for i in range(n_frames)
    ])).to(dev)
    fe = sf.front_end(params, (H, W), sf.DEFAULT_MBF, sf.DEFAULT_FX, str(dev))
    for i in range(warmup):
        fe(pairs[i % n_frames]).cpu()
    torch.cuda.synchronize(dev)

    wall, window = [], []
    for i in range(n_frames):
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        packed = fe(pairs[i])
        end.record()
        host = packed.cpu()
        wall.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        window.append(start.elapsed_time(end))
    if not np.isfinite(host.numpy()).all():
        raise RuntimeError("the front-end returned values that are not finite")
    eager = [window_ms(lambda: fe.eager(pairs[i])) for i in range(n_frames)]

    per_frame = []
    for b0 in range(0, n_frames - batch + 1, batch):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fe.batch(pairs[b0 : b0 + batch]).cpu()
        per_frame.append((time.perf_counter() - t0) * 1e3 / batch)
    return dict(
        wall_ms=statistics.median(wall), window_ms=statistics.median(window),
        eager_window_ms=statistics.median(eager),
        batch_ms=statistics.median(per_frame) if per_frame else None,
        frames=n_frames, batch=batch, keypoints=int(host.shape[0]),
    )


def final_line(value: float | None) -> dict:
    return {
        "metric": HEADLINE_METRIC,
        "value": None if value is None else round(value, 3),
        "unit": "ms",
        "vs_baseline": None if value is None else round(BASELINE_EXTRACT_MS / value, 2),
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    a = ap.parse_args(argv)
    value = None
    try:
        r = measure(a.frames, a.warmup, a.batch)
        card = torch.cuda.get_device_name(0)
        print(json.dumps({
            "metric": "stereo_front_end_stream_window_ms_per_frame",
            "value": r["window_ms"], "unit": "ms", "device": card,
            "note": "median CUDA-event window around StereoFrontEnd.forward (one graph "
                    "replay), copy excluded",
        }), flush=True)
        print(json.dumps({
            "metric": "stereo_front_end_eager_stream_window_ms_per_frame",
            "value": r["eager_window_ms"], "unit": "ms", "device": card,
            "note": "median CUDA-event window around StereoFrontEnd.eager (the same program "
                    "op by op) on the same pairs",
        }), flush=True)
        if r["batch_ms"] is not None:
            print(json.dumps({
                "metric": "stereo_front_end_batched_ms_per_frame", "value": r["batch_ms"],
                "unit": "ms", "batch": r["batch"], "device": card,
                "note": "median wall of StereoFrontEnd.batch over B pairs plus one copy, / B",
            }), flush=True)
        print(json.dumps({
            "metric": "vs_reference_extract_plus_match",
            "value": round((BASELINE_EXTRACT_MS + BASELINE_MATCH_MS) / r["wall_ms"], 2),
            "reference_ms": BASELINE_EXTRACT_MS + BASELINE_MATCH_MS, "device": card,
            "note": "the reference GPU fork's extraction 38.53 + stereo matching 7.74 ms "
                    "(ExecMean.txt:6-7) over the headline",
        }), flush=True)
        value = r["wall_ms"]
    except Exception as e:  # noqa: BLE001 — the final line is printed whatever failed
        print(f"bench failed: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
    print(json.dumps(final_line(value)), flush=True)
    return 0 if value is not None else 1


if __name__ == "__main__":
    sys.exit(main())
