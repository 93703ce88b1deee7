"""Run RGB-D SLAM on a TUM-RGBD sequence directory.

Usage:
  python -m orbslam3_tpu_torch.examples.run_tum_rgbd <sequence dir> <settings.yaml>
      [voc] [assoc] [--device cuda|cpu] [--fused detect,moments,sample]

Expects TUM layout: rgb/*.png, depth/*.png (16-bit, 5000 units/m unless
RGBD.DepthMapFactor says otherwise), and an associations file (default
associations.txt: `t_rgb rgb/... t_depth depth/...` per line; generate with
the TUM associate.py tool).  The colour image is read as grey and the
depth unchanged, with utils.imageio (no cv2).  Writes CameraTrajectory.txt
(TUM format) — the reference's rgbd_tum example contract.
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


def load_associations(path: str):
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t_rgb, rgb, _t_d, depth = line.split()[:4]
            pairs.append((float(t_rgb), rgb, depth))
    return pairs


def main(seq_dir: str, settings_path: str, voc_path: str | None = None,
         assoc: str | None = None, *, device: str = "cuda",
         fused: FusedKernels = FusedKernels(), out_dir: str = "."):
    from orbslam3_tpu_torch.slam.system import System

    assoc = assoc or os.path.join(seq_dir, "associations.txt")
    pairs = load_associations(assoc)
    print(f"{len(pairs)} associated frames")

    slam = System.from_files(voc_path, settings_path, sensor=System.RGBD, device=device,
                             fused=fused)
    t_track = []
    for k, (ts, rgb_rel, depth_rel) in enumerate(pairs):
        img = read_image(os.path.join(seq_dir, rgb_rel))
        depth = read_image(os.path.join(seq_dir, depth_rel), unchanged=True)
        t0 = time.perf_counter()
        with Benchmark.the().measure(TRACK_TAG):
            slam.track_rgbd(img, depth, ts)
        t_track.append(time.perf_counter() - t0)
        if k % 100 == 0:
            st = slam.map_stats()
            print(f"frame {k}: {st['n_keyframes']} KFs, "
                  f"{st['n_map_points']} MPs, {t_track[-1]*1e3:.1f} ms")
    slam.shutdown()
    slam.save_trajectory_tum(os.path.join(out_dir, "CameraTrajectory.txt"))
    print(f"median track {np.median(t_track)*1e3:.1f} ms; {timing_summary()}; "
          f"wrote CameraTrajectory.txt")
    return slam


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="TUM-RGBD driver (reference rgbd_tum)")
    ap.add_argument("seq_dir")
    ap.add_argument("settings")
    ap.add_argument("voc", nargs="?", default=None)
    ap.add_argument("assoc", nargs="?", default=None)
    add_device_options(ap)
    a = ap.parse_args()
    main(a.seq_dir, a.settings, a.voc, a.assoc, device=a.device, fused=parse_fused(a.fused))
