"""A synthetic stereo-inertial sequence at the TUM-VI configuration.

TUM-VI's stereo-inertial settings (two KannalaBrandt8 cameras at 512x512
whose lapping areas span the whole image, the 0.101 m stereo extrinsics
`Stereo.T_c1_c2`, the IMU noise and `IMU.T_b_c1`, 1000 ORB features on 8
levels) as a settings file for `System.from_files`, and a sequence that
renders two textured walls through those cameras along a sweep with
acceleration and rotation in every axis (so gravity and the biases are
observable for the visual-inertial initialisation), with the IMU samples
between frames from `utils.synth.imu_samples_between`.

`chip_smoke.py` phase 14 drives the port's `System` over it on the card;
`tests/test_torch_fisheye.py` runs it at small sizes on the CPU.  Numpy
only.
"""

from __future__ import annotations

import os

import numpy as np

from orbslam3_tpu_torch.utils.lie import SE3, so3_exp
from orbslam3_tpu_torch.utils.synth import (
    PlaneWorld,
    imu_samples_between,
    make_texture,
    render_world,
)

FPS = 20.0

# TUM-VI's stereo-inertial settings (room sequences, 512x512)
TUMVI_YAML = """%YAML:1.0
---
File.version: "1.0"
Camera.type: "KannalaBrandt8"
Camera1.fx: 190.978477
Camera1.fy: 190.973307
Camera1.cx: 254.931706
Camera1.cy: 256.897442
Camera1.k1: 0.003482389402
Camera1.k2: 0.000715034845
Camera1.k3: -0.002053236141
Camera1.k4: 0.000202936736
Camera1.overlappingBegin: 0
Camera1.overlappingEnd: 511
Camera2.fx: 190.44236969
Camera2.fy: 190.4344384
Camera2.cx: 252.59949089
Camera2.cy: 254.91723356
Camera2.k1: 0.0034003170790
Camera2.k2: 0.001976708358
Camera2.k3: -0.002950517290
Camera2.k4: 0.00067033991
Camera2.overlappingBegin: 0
Camera2.overlappingEnd: 511
Camera.width: 512
Camera.height: 512
Camera.fps: 20
Camera.RGB: 1
Stereo.ThDepth: 40.0
Stereo.T_c1_c2: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.999997256,0.002312067,0.000376008,0.101063,
          -0.002317135,0.999898049,0.014089835,0.001946,
          -0.000343393,-0.014090668,0.99990063,0.001015,
          0.0,0.0,0.0,1.0]
Stereo.b: 0.101
IMU.NoiseGyro: 0.00016
IMU.NoiseAcc: 0.0028
IMU.GyroWalk: 0.000022
IMU.AccWalk: 0.00086
IMU.Frequency: 200.0
IMU.T_b_c1: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [-0.9995250378696743,0.029615343885863205,-0.008522328211654736,0.04727988224914392,
          0.0075019185074052044,-0.03439736061393144,-0.9993800792498829,-0.047443232143367084,
          -0.02989013031643309,-0.998969345370175,0.03415885127385616,-0.0681999605066297,
          0.0,0.0,0.0,1.0]
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
Viewer.KeyFrameSize: 0.05
"""


def write_settings(directory: str, h: int = 512, w: int = 512) -> str:
    """The settings above as `tumvi.yaml` in `directory`; returns its path.
    Another image size scales fx, fy and cx by w / 512 and cy by h / 512
    (a smaller image of the same rig, cropped vertically when h < w)."""
    scale = {"fx": w / 512, "fy": w / 512, "cx": w / 512, "cy": h / 512}
    lines = []
    for line in TUMVI_YAML.splitlines():
        key, _, value = line.partition(": ")
        name = key.split(".")[-1]
        if key.startswith("Camera") and name in scale:
            line = f"{key}: {float(value) * scale[name]!r}"
        elif key == "Camera.width" or key.endswith(".overlappingEnd"):
            line = f"{key}: {w if key == 'Camera.width' else w - 1}"
        elif key == "Camera.height":
            line = f"{key}: {h}"
        lines.append(line)
    path = os.path.join(directory, "tumvi.yaml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def world() -> list:
    return [
        PlaneWorld(
            make_texture(2048, 3),
            p0=[-4.0, -3.0, 2.8], ex=[1.0, 0.0, -0.15], ey=[0.0, 1.0, 0.08],
            scale=0.004,
        ),
        PlaneWorld(
            make_texture(1024, 4),
            p0=[-2.5, -2.0, 1.6], ex=[1.0, 0.0, 0.3], ey=[0.0, 1.0, -0.1],
            scale=0.003,
        ),
    ]


def pose(k: float) -> SE3:
    """Camera-in-world at (fractional) frame k: a smooth sweep with
    acceleration and rotation excitation in every axis."""
    t = np.array([
        0.04 * k,
        0.02 * np.sin(0.5 * k),
        0.01 * k + 0.015 * np.cos(0.4 * k) - 0.015,
    ])
    r = np.array([0.006 * np.sin(0.3 * k), -0.008 * k, 0.004 * np.cos(0.45 * k) - 0.004])
    return SE3(so3_exp(r), t)


def sequence(cam_l, cam_r, Tlr: SE3, Tbc: SE3, h: int, w: int, n_frames: int) -> list:
    """[(img_l, img_r, Tcw of the left camera, imu)]: the walls rendered by
    both cameras (right = Tlr^-1 * left), imu = (acc, gyro, dts) since the
    previous frame in the body frame of `Tbc`, None at frame 0."""
    walls = world()
    t_rl = Tlr.inverse()
    out = []
    for k in range(n_frames):
        tcw = pose(k).inverse()
        imu = imu_samples_between(k - 1, k, FPS, Tbc=Tbc, pose_fn=pose) if k > 0 else None
        out.append((
            render_world(walls, cam_l, tcw, h, w),
            render_world(walls, cam_r, t_rl * tcw, h, w),
            tcw,
            imu,
        ))
    return out


def system_sequence(system, n_frames: int) -> list:
    """`sequence` through a fisheye System's own cameras, extrinsics and
    image size (from its settings)."""
    st = system.settings
    return sequence(
        system.camera, system.camera2, system.Tlr, system.imu_calib.Tbc,
        st.height, st.width, n_frames,
    )
