"""Multi-robot SLAM: N independent System instances sharing ONE card.

Each step, every robot's stereo pair joins one batched front-end dispatch
(System.prefetch_stereo_batch on the first System — one program into one
packed (B, K, 40) block and one copy to the host), and each robot's own
System consumes its row.  The reference is strictly single-session per
process (one Tracking thread, ORB_SLAM3/src/System.cc:197); this is a
capability beyond parity, built on the same public API.

Usage: python -m orbslam3_tpu_torch.examples.run_multi_robot [n_robots]
           [n_frames] [--device cuda|cpu] [--fused detect,moments,sample]
"""

from __future__ import annotations

import time

import numpy as np

from orbslam3_tpu_torch.cameras.models import Pinhole
from orbslam3_tpu_torch.ops.extractor import FusedKernels
from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams
from orbslam3_tpu_torch.utils.synth import ate_rmse, stereo_sequence

FX, H, W = 350.0, 480, 752
FPS = 20.0


def main(n_robots=2, n_frames=60, n_features=1000, h=H, w=W, *, device: str = "cuda",
         fused: FusedKernels = FusedKernels()):
    from orbslam3_tpu_torch.slam.system import System

    camera = Pinhole([FX, FX, w / 2, h / 2])
    mbf = FX * 0.12
    params = PyramidParams(n_features=n_features)
    # distinct worlds/trajectories per robot (different seeds)
    streams = [
        stereo_sequence(n_frames, camera, 0.12, h, w, seed=11 + 7 * r)
        for r in range(n_robots)
    ]
    systems = [
        System(camera, mbf, params, sequential=True, max_frames=6, device=device, fused=fused)
        for _ in range(n_robots)
    ]

    est = [[] for _ in range(n_robots)]
    gt = [[] for _ in range(n_robots)]
    t_frame = []
    for k in range(n_frames):
        t0 = time.perf_counter()
        pairs = [streams[r][k][:2] for r in range(n_robots)]
        # ONE front-end dispatch serves the whole fleet's frame k
        handles = systems[0].prefetch_stereo_batch(pairs)
        for r in range(n_robots):
            pose = systems[r].track_stereo_prefetched(handles[r], k / FPS)
            if pose is not None:
                est[r].append(pose)
                gt[r].append(streams[r][k][2])
        t_frame.append(time.perf_counter() - t0)

    med = float(np.median(t_frame) * 1e3)
    print(f"{n_robots} robots x {n_frames} frames; "
          f"median step {med:.1f} ms ({med / n_robots:.1f} ms/robot-frame)")
    for r in range(n_robots):
        n_tracked = len(est[r])
        ate = ate_rmse(est[r], gt[r]) if n_tracked > 5 else float("nan")
        stats = systems[r].map_stats()
        print(f"  robot {r}: tracked {n_tracked}/{n_frames}, "
              f"ATE {ate * 100:.2f} cm, KFs {stats['n_keyframes']}, "
              f"MPs {stats['n_map_points']}")
    for s in systems:
        s.shutdown()
    return systems, est, gt


if __name__ == "__main__":
    import argparse

    from orbslam3_tpu_torch.examples.common import add_device_options, parse_fused

    ap = argparse.ArgumentParser(description="N robots' SLAM on one card")
    ap.add_argument("n_robots", nargs="?", type=int, default=2)
    ap.add_argument("n_frames", nargs="?", type=int, default=60)
    add_device_options(ap)
    a = ap.parse_args()
    main(a.n_robots, a.n_frames, device=a.device, fused=parse_fused(a.fused))
