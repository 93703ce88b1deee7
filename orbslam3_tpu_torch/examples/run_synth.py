"""End-to-end SLAM on a synthetic stereo sequence with exact ground truth.

Usage: python -m orbslam3_tpu_torch.examples.run_synth [n_frames] [h] [w]
           [--device cuda|cpu] [--fused detect,moments,sample]
Prints per-frame tracking state and final ATE RMSE.
"""

from __future__ import annotations

import time

import numpy as np

from orbslam3_tpu_torch.cameras.models import Pinhole
from orbslam3_tpu_torch.ops.extractor import FusedKernels
from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams
from orbslam3_tpu_torch.utils.synth import ate_rmse, stereo_sequence


def main(n_frames=40, h=384, w=512, *, device: str = "cuda",
         fused: FusedKernels = FusedKernels()):
    from orbslam3_tpu_torch.slam.system import System

    fx = 350.0
    camera = Pinhole([fx, fx, w / 2, h / 2])
    baseline = 0.12
    mbf = fx * baseline
    params = PyramidParams(n_features=900)

    print(f"rendering {n_frames} synthetic frames ({h}x{w})...")
    frames = stereo_sequence(n_frames, camera, baseline, h, w, seed=1)

    sysm = System(camera, mbf, params, sequential=True, device=device, fused=fused)
    est, gt = [], []
    t_start = time.time()
    for k, (img_l, img_r, tcw_gt) in enumerate(frames):
        t0 = time.time()
        pose = sysm.track_stereo(img_l, img_r, timestamp=k / 20.0)
        dt = (time.time() - t0) * 1e3
        st = sysm.get_tracking_state().name
        stats = sysm.map_stats()
        if pose is not None:
            est.append(pose)
            gt.append(tcw_gt)
        print(
            f"frame {k:3d}: {st:15s} pose={'ok' if pose is not None else '--'} "
            f"inliers={sysm.tracker.matches_inliers:4d} "
            f"KFs={stats['n_keyframes']:3d} MPs={stats['n_map_points']:5d} {dt:6.1f} ms"
        )
    sysm.shutdown()
    print(f"total {time.time()-t_start:.1f}s")
    rmse = None
    if len(est) > 5:
        rmse = ate_rmse(est, gt)
        dist = np.linalg.norm(np.diff(np.stack([t.inverse().t for t in gt]), axis=0), axis=1).sum()
        print(f"ATE RMSE: {rmse*100:.2f} cm over {dist:.2f} m trajectory, {len(est)} poses")
    else:
        print("TRACKING FAILED")
    return sysm, est, gt, rmse


if __name__ == "__main__":
    import argparse

    from orbslam3_tpu_torch.examples.common import add_device_options, parse_fused

    ap = argparse.ArgumentParser(description="SLAM on a synthetic stereo sequence")
    ap.add_argument("sizes", nargs="*", type=int, help="[n_frames] [h] [w]")
    add_device_options(ap)
    a = ap.parse_args()
    main(*a.sizes, device=a.device, fused=parse_fused(a.fused))
