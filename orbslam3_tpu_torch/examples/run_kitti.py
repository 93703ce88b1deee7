"""Run stereo SLAM on a KITTI odometry sequence directory.

Usage:
  python -m orbslam3_tpu_torch.examples.run_kitti <sequence dir> <settings.yaml>
      [voc] [--device cuda|cpu] [--fused detect,moments,sample]

Expects KITTI odometry layout: image_0/*.png (left), image_1/*.png (right),
times.txt.  Writes CameraTrajectory.txt in the KITTI format (the
reference's stereo_kitti example output).  KITTI images are already
rectified, so the settings file typically uses Camera.type
"Rectified"/"PinHole" without a second camera; Camera.bf sets the stereo
baseline.  Images are read with utils.imageio (no cv2).
"""

from __future__ import annotations

import os
import time

import numpy as np

from orbslam3_tpu_torch.examples.common import (
    TRACK_TAG,
    add_device_options,
    parse_fused,
    read_image,
    timing_summary,
)
from orbslam3_tpu_torch.ops.extractor import FusedKernels
from orbslam3_tpu_torch.utils.benchmark import Benchmark


def main(seq_dir: str, settings_path: str, voc_path: str | None = None, *,
         device: str = "cuda", fused: FusedKernels = FusedKernels(), out_dir: str = "."):
    from orbslam3_tpu_torch.slam.system import System

    left_dir = os.path.join(seq_dir, "image_0")
    right_dir = os.path.join(seq_dir, "image_1")
    with open(os.path.join(seq_dir, "times.txt")) as f:
        times = [float(t) for t in f.read().split()]
    names = sorted(os.listdir(left_dir))
    print(f"{len(names)} frames")

    slam = System.from_files(voc_path, settings_path, sensor="stereo", device=device, fused=fused)
    t_track = []
    for k, name in enumerate(names):
        il = read_image(os.path.join(left_dir, name))
        ir = read_image(os.path.join(right_dir, name))
        t0 = time.perf_counter()
        with Benchmark.the().measure(TRACK_TAG):
            slam.track_stereo(il, ir, times[k])
        t_track.append(time.perf_counter() - t0)
        if k % 100 == 0:
            st = slam.map_stats()
            print(f"frame {k}: {st['n_keyframes']} KFs, "
                  f"{st['n_map_points']} MPs, {t_track[-1]*1e3:.1f} ms")
    slam.shutdown()
    slam.save_trajectory_kitti(os.path.join(out_dir, "CameraTrajectory.txt"))
    print(f"median track {np.median(t_track)*1e3:.1f} ms; {timing_summary()}; "
          f"wrote CameraTrajectory.txt")
    return slam


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="KITTI odometry driver (reference stereo_kitti)")
    ap.add_argument("seq_dir")
    ap.add_argument("settings")
    ap.add_argument("voc", nargs="?", default=None)
    add_device_options(ap)
    a = ap.parse_args()
    main(a.seq_dir, a.settings, a.voc, device=a.device, fused=parse_fused(a.fused))
