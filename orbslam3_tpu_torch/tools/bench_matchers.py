"""Host vs device SearchByProjection at realistic candidate counts.

The port's counterpart of the reference's `bench_matchers.py`: the same
`make_scene` (one 640x480 frame of 1000 keypoints, n map points marked in
view), the host matcher (`matchers.search_by_projection_local_map`, the
native C++ grid walk) against the port's device matcher
(`search_by_projection_local_map_device`, `ops/matching` on the torch
device), each the best host wall of 5 calls.  Prints one JSON line per
candidate count, 500 / 2000 / 10000 as the reference and 30000 / 100000
to bracket the crossover that sets `slam/matchers.DEVICE_MATCH_MIN`.

Usage: python -m orbslam3_tpu_torch.tools.bench_matchers [n ...] [--device=cpu]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

SIZES = (500, 2000, 10000, 30000, 100000)


def make_scene(n_mps: int, n_kps: int = 1000, seed: int = 0):
    from orbslam3_tpu_torch.cameras.models import Pinhole
    from orbslam3_tpu_torch.slam.frame import Frame
    from orbslam3_tpu_torch.slam.map_point import MapPoint
    from orbslam3_tpu_torch.utils.lie import SE3

    rng = np.random.default_rng(seed)
    cam = Pinhole([400.0, 400.0, 320.0, 240.0])
    scales = 1.2 ** np.arange(8)
    pts = rng.uniform(-1, 1, (n_mps, 3)) * [4, 3, 2] + [0, 0, 8]
    # keypoints: projections of a subset + clutter
    vis = pts[: n_kps // 2]
    uv_vis = cam.project(vis) + rng.normal(0, 0.5, (len(vis), 2))
    uv_clutter = rng.uniform([0, 0], [640, 480], (n_kps - len(vis), 2))
    uv = np.concatenate([uv_vis, uv_clutter])
    descs = rng.integers(0, 256, (n_mps, 32)).astype(np.uint8)
    kp_desc = np.concatenate(
        [descs[: n_kps // 2], rng.integers(0, 256, (n_kps - n_kps // 2, 32)).astype(np.uint8)]
    )
    frame = Frame(
        kps=uv, octave=np.zeros(n_kps, np.int32), angle=np.zeros(n_kps, np.float32),
        response=np.ones(n_kps, np.float32), desc=kp_desc, camera=cam,
        scale_factors=scales, mbf=0.0,
    )
    frame.set_image_bounds(0, 0, 640, 480)
    frame.set_pose(SE3())
    mps = []
    for k in range(n_mps):
        mp = MapPoint(pts[k], None, None)
        mp.descriptor = descs[k]
        proj = cam.project(pts[k][None])[0]
        mp.track_in_view = bool(0 <= proj[0] < 640 and 0 <= proj[1] < 480)
        mp.track_proj = (proj[0], proj[1], -1.0, 0, 1.0)
        mps.append(mp)
    return frame, mps


def bench(fn, frame, reps=5):
    best = np.inf
    for _ in range(reps):
        frame.map_points[:] = None
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def matched(fn, frame) -> np.ndarray:
    """The map point id each keypoint is matched to (-1: none) by fn."""
    frame.map_points[:] = None
    fn()
    return np.asarray([-1 if mp is None else mp.id for mp in frame.map_points])


def run(sizes=SIZES, device: str = "cuda") -> list:
    import torch

    from orbslam3_tpu_torch.slam import matchers

    dev = torch.device(device)
    out = []
    for n in sizes:
        frame, mps = make_scene(n)
        t_host = bench(
            lambda: matchers.search_by_projection_local_map(frame, mps, th=2.0),
            frame,
        )
        # warm the device path (the first call builds the matcher's tables)
        matchers.search_by_projection_local_map_device(frame, mps, th=2.0, device=dev)
        t_dev = bench(
            lambda: matchers.search_by_projection_local_map_device(frame, mps, th=2.0,
                                                                   device=dev),
            frame,
        )
        faster = "host" if t_host <= t_dev else "device"
        line = {
            "metric": f"search_by_projection_{n}_mps_ms",
            "host_ms": round(t_host, 2),
            "device_ms": round(t_dev, 2),
            "faster": faster,
        }
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


def main(argv=None) -> int:
    from orbslam3_tpu_torch.tools.card import open_device

    argv = sys.argv[1:] if argv is None else argv
    device = next((a.split("=", 1)[1] for a in argv if a.startswith("--device=")), "cuda")
    sizes = [int(a) for a in argv if not a.startswith("--")] or SIZES
    if open_device("bench_matchers", device) is None:
        return 1
    run(sizes, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
