"""Run stereo-fisheye-inertial SLAM on a TUM-VI sequence.

Usage:
  python -m orbslam3_tpu_torch.examples.run_tumvi <mav0 dir> <settings.yaml>
      [voc] [--sensor stereo-inertial|stereo] [--pipeline N] [--batch N]
      [--device cuda|cpu] [--fused detect,moments,sample]

TUM-VI distributes its sequences in the same EuRoC/ASL layout
(dataset-room1_512_16/mav0/{cam0,cam1}/data/*.png + data.csv,
mav0/imu0/data.csv), so the drive loop is run_euroc's; what makes a run
TUM-VI is the settings file: two KannalaBrandt8 cameras with
Camera.lappingBegin/End overlap areas and IMU.T_b_c1 extrinsics.  The
System wires those into the fisheye stereo front-end (overlap kNN matching
+ KB8 triangulation — reference src/Frame.cc:1089-1135) and the inertial
tracker (IMU_STEREO, the reference's stereo_inertial_tum_vi example role).

Writes CameraTrajectory.txt and KeyFrameTrajectory.txt (TUM format).
"""

from __future__ import annotations

from orbslam3_tpu_torch.examples.run_euroc import main as _drive_loop, parse_args
from orbslam3_tpu_torch.ops.extractor import FusedKernels


def main(seq_dir: str, settings_path: str, voc_path: str | None = None,
         sensor: str = "stereo-inertial", pipeline: int = 0, batch: int = 0, *,
         device: str = "cuda", fused: FusedKernels = FusedKernels(), out_dir: str = "."):
    return _drive_loop(seq_dir, settings_path, voc_path, sensor=sensor, pipeline=pipeline,
                       batch=batch, device=device, fused=fused, out_dir=out_dir)


if __name__ == "__main__":
    a, kw = parse_args(
        "TUM-VI sequence driver (reference stereo_inertial_tum_vi contract): seq_dir "
        "holds mav0-style cam0/data, cam1/data, imu0/data.csv; settings is a KB8 "
        "stereo(-inertial) yaml with lapping areas.  Writes CameraTrajectory.txt and "
        "KeyFrameTrajectory.txt (TUM format).",
        "stereo-inertial", legacy_sensor=False,
    )
    main(a.seq_dir, a.settings, a.voc, **kw)
