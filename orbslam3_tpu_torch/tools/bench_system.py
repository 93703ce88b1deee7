"""End-to-end throughput of the whole System on the card.

Unlike `bench.py` (the front-end alone), this drives the WHOLE System:
the device front-end (one CUDA graph replay a frame), host tracking,
local mapping and BA on their threads, over a synthetic stereo sequence
with the 1-frame prefetch pipeline (`System.prefetch_stereo` /
`track_stereo_prefetched`): the next frame's front-end runs on a side
stream while the host tracks the current one.  The port's counterpart of
the reference's `tools/bench_system.py`, with the same setup and the same
two JSON lines: `slam_system_ms_per_frame_pipelined` (median host wall of
one pipelined frame after warm-up, with mean, p90, fps, frames, tracked
and the ATE RMSE) and `slam_system_wall_s`.

Usage: python -m orbslam3_tpu_torch.tools.bench_system [n_frames] [h] [w]
           [--device=cpu]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def run(n_frames: int = 120, h: int = 480, w: int = 752, device: str = "cuda") -> list:
    """The two result dicts of `n_frames` pipelined frames on `device`."""
    from orbslam3_tpu_torch.cameras.models import Pinhole
    from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams
    from orbslam3_tpu_torch.slam.system import System
    from orbslam3_tpu_torch.tools.card import device_name
    from orbslam3_tpu_torch.utils.synth import ate_rmse, stereo_sequence

    fx = 350.0
    camera = Pinhole([fx, fx, w / 2, h / 2])
    baseline = 0.12
    mbf = fx * baseline
    params = PyramidParams(n_features=1000)

    frames = stereo_sequence(n_frames, camera, baseline, h, w, seed=1)
    imgs = [(l, r) for (l, r, _) in frames]
    gt_poses = [t for (_, _, t) in frames]

    # threaded (the reference's configuration): LocalMapping and
    # LoopClosing on their own threads, so keyframe work overlaps tracking
    sysm = System(camera, mbf, params, sequential=False, device=device)

    # warm-up: the first frames capture the front-end's graph and build
    # the kernels
    warm = min(10, n_frames // 4)
    est, gt = [], []
    times = []
    handle = sysm.prefetch_stereo(*imgs[0])
    t_all0 = time.perf_counter()
    for k in range(n_frames):
        t0 = time.perf_counter()
        if k + 1 < n_frames:
            next_handle = sysm.prefetch_stereo(*imgs[k + 1])
        pose = sysm.track_stereo_prefetched(handle, k / 20.0)
        if k + 1 < n_frames:
            handle = next_handle
        dt = (time.perf_counter() - t0) * 1e3
        if k >= warm:
            times.append(dt)
        if pose is not None:
            est.append(pose)
            gt.append(gt_poses[k])
    wall = time.perf_counter() - t_all0
    sysm.shutdown()

    times = np.array(times)
    program = ("one CUDA graph replay a frame" if sysm.device.type == "cuda"
               else "op by op on the CPU")
    rmse = ate_rmse(est, gt) if len(est) >= 2 else float("nan")
    return [
        {
            "metric": "slam_system_ms_per_frame_pipelined",
            "value": round(float(np.median(times)), 2),
            "unit": "ms",
            "mean": round(float(times.mean()), 2),
            "p90": round(float(np.percentile(times, 90)), 2),
            "fps": round(1e3 / float(np.median(times)), 1),
            "frames": n_frames,
            "tracked": len(est),
            "ate_rmse_m": round(float(rmse), 4),
            "note": (f"front-end ({program}) + full host tracking, threaded mapping, "
                     f"1-frame prefetch pipeline on {device_name(sysm.device)}"),
        },
        {"metric": "slam_system_wall_s", "value": round(wall, 2), "unit": "s"},
    ]


def main(argv=None) -> int:
    from orbslam3_tpu_torch.tools.card import open_device

    argv = sys.argv[1:] if argv is None else argv
    device = next((a.split("=", 1)[1] for a in argv if a.startswith("--device=")), "cuda")
    if open_device("bench_system", device) is None:
        return 1
    args = [int(a) for a in argv if not a.startswith("--")][:3]
    for line in run(*args, device=device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
