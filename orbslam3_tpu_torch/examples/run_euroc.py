"""Run stereo or stereo-inertial SLAM on a EuRoC-format sequence directory.

Usage:
  python -m orbslam3_tpu_torch.examples.run_euroc <mav0 dir> <settings.yaml>
      [voc] [sensor] [--sensor stereo|stereo-inertial] [--pipeline N]
      [--batch N] [--device cuda|cpu] [--fused detect,moments,sample]

  sensor: stereo (default) | stereo-inertial (4th positional or --sensor)
  --pipeline N: prefetch N frames of device extraction ahead of host
      tracking (0 = synchronous, the reference drive-loop behavior)
  --batch N: batched-throughput mode, N frames per front-end dispatch
  --device: the front-end's device (default cuda; raises without a GPU)
  --fused: the fused kernels to run (FusedKernels; default none)

Expects EuRoC ASL layout: mav0/cam0/data/*.png, mav0/cam1/data/*.png,
mav0/cam0/data.csv for timestamps, mav0/imu0/data.csv for IMU
(timestamp[ns], wx, wy, wz, ax, ay, az).  Writes CameraTrajectory.txt (TUM)
and KeyFrameTrajectory.txt (the reference's output artifacts).  Images are
read with utils.imageio (no cv2); an unrectified rig is rectified on the
System's device.
"""

from __future__ import annotations

import csv
import os
import time
from collections import deque

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


def load_timestamps(cam_dir: str):
    rows = []
    with open(os.path.join(cam_dir, "data.csv")) as f:
        for row in csv.reader(f):
            if row and not row[0].startswith("#"):
                rows.append((int(row[0]), row[1].strip()))
    return rows


def load_imu(imu_dir: str):
    """(t_ns (N,), gyro (N,3), acc (N,3)) from EuRoC imu0/data.csv."""
    ts, gyro, acc = [], [], []
    with open(os.path.join(imu_dir, "data.csv")) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts.append(int(row[0]))
            gyro.append([float(x) for x in row[1:4]])
            acc.append([float(x) for x in row[4:7]])
    return np.asarray(ts), np.asarray(gyro), np.asarray(acc)


def imu_between(imu_ts, imu_gyro, imu_acc, prev_ns: int, ns: int):
    """(acc, gyro, dts) of the samples in (prev_ns, ns], or None."""
    sel = (imu_ts > prev_ns) & (imu_ts <= ns)
    if not sel.any():
        return None
    dts = np.diff(np.concatenate([[prev_ns], imu_ts[sel]])) * 1e-9
    return imu_acc[sel], imu_gyro[sel], dts


def main(seq_dir: str, settings_path: str, voc_path: str | None = None,
         sensor: str = "stereo", pipeline: int = 0, batch: int = 0, *,
         device: str = "cuda", fused: FusedKernels = FusedKernels(), out_dir: str = "."):
    """`pipeline` > 0 prefetches that many frames of device extraction
    ahead of host tracking (System.prefetch_stereo /
    track_stereo_prefetched), overlapping extraction dispatch + D2H copy
    with tracking.  0 = synchronous track_stereo (reference stereo_euroc
    behavior).

    `batch` > 0 instead dispatches the front-end for windows of `batch`
    frames at once (System.prefetch_stereo_batch) — the throughput mode
    for offline/mapping-rate runs; per-frame latency inside a window is
    uneven, so the real-time loop prefers `pipeline`.  The trajectories
    go to `out_dir`."""
    from orbslam3_tpu_torch.slam.system import System

    cam0 = os.path.join(seq_dir, "cam0")
    cam1 = os.path.join(seq_dir, "cam1")
    stamps = load_timestamps(cam0)
    print(f"{len(stamps)} frames")

    inertial = "inertial" in sensor or "imu" in sensor
    imu_ts = imu_gyro = imu_acc = None
    if inertial:
        imu_ts, imu_gyro, imu_acc = load_imu(os.path.join(seq_dir, "imu0"))
        print(f"{len(imu_ts)} IMU samples")

    slam = System.from_files(voc_path, settings_path, sensor=sensor, device=device, fused=fused)
    bench = Benchmark.the()
    t_start = time.time()
    prev_ns = None

    def _load(fname):
        left = read_image(os.path.join(cam0, "data", fname))
        right = read_image(os.path.join(cam1, "data", fname))
        return (left, right) if left is not None and right is not None else None

    fifo: deque = deque()  # (handle, ns) when pipelined
    feed = iter(stamps)
    for k, (ns, fname) in enumerate(stamps):
        if batch > 0:
            if not fifo:
                # refill: one batched dispatch serves the next `batch` frames
                window = []
                while len(window) < batch:
                    try:
                        ns_n, fname_n = next(feed)
                    except StopIteration:
                        break
                    pair = _load(fname_n)
                    if pair is not None:
                        window.append((pair, ns_n))
                if not window:
                    break
                handles = slam.prefetch_stereo_batch([p for p, _ in window])
                fifo.extend((h, ns_n) for h, (_, ns_n) in zip(handles, window))
            handle, ns = fifo.popleft()
        elif pipeline > 0:
            while len(fifo) <= pipeline:
                try:
                    ns_n, fname_n = next(feed)
                except StopIteration:
                    break
                pair = _load(fname_n)
                if pair is not None:
                    fifo.append((slam.prefetch_stereo(*pair), ns_n))
            if not fifo:
                break
            handle, ns = fifo.popleft()
        else:
            pair = _load(fname)
            if pair is None:
                continue
        imu = None
        if inertial and prev_ns is not None:
            imu = imu_between(imu_ts, imu_gyro, imu_acc, prev_ns, ns)
        with bench.measure(TRACK_TAG):
            if batch > 0 or pipeline > 0:
                slam.track_stereo_prefetched(handle, ns * 1e-9, imu=imu)
            else:
                slam.track_stereo(*pair, ns * 1e-9, imu=imu)
        prev_ns = ns
        if k % 50 == 0:
            st = slam.map_stats()
            m = slam.atlas.get_current_map()
            extra = " VI" if getattr(m, "imu_initialized", False) else ""
            print(
                f"frame {k}: {slam.get_tracking_state().name}{extra} "
                f"KFs={st['n_keyframes']} MPs={st['n_map_points']}"
            )
    dt = time.time() - t_start
    print(f"{len(stamps)} frames in {dt:.1f}s ({len(stamps)/dt:.1f} fps); {timing_summary()}")
    slam.save_trajectory_tum(os.path.join(out_dir, "CameraTrajectory.txt"))
    slam.save_keyframe_trajectory_tum(os.path.join(out_dir, "KeyFrameTrajectory.txt"))
    slam.shutdown()
    return slam


def parse_args(description: str, default_sensor: str, legacy_sensor: bool):
    import argparse

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("seq_dir")
    ap.add_argument("settings")
    ap.add_argument("voc", nargs="?", default=None)
    if legacy_sensor:
        ap.add_argument("sensor_pos", nargs="?", default=None, metavar="sensor",
                        help="legacy 4th positional: stereo | stereo-inertial")
    ap.add_argument("--sensor", default=default_sensor, help="stereo | stereo-inertial")
    ap.add_argument("--pipeline", type=int, default=0,
                    help="prefetch depth (0 = synchronous)")
    ap.add_argument("--batch", type=int, default=0,
                    help="batched-throughput mode: B frames per front-end dispatch")
    add_device_options(ap)
    a = ap.parse_args()
    return a, dict(
        sensor=getattr(a, "sensor_pos", None) or a.sensor, pipeline=max(0, a.pipeline),
        batch=max(0, a.batch), device=a.device, fused=parse_fused(a.fused),
    )


if __name__ == "__main__":
    a, kw = parse_args(
        "EuRoC sequence driver (reference stereo_euroc / stereo_inertial_euroc "
        "contract): seq_dir holds cam0/data, cam1/data, imu0/data.csv.  Writes "
        "CameraTrajectory.txt and KeyFrameTrajectory.txt (TUM format).",
        "stereo", legacy_sensor=True,
    )
    main(a.seq_dir, a.settings, a.voc, **kw)
