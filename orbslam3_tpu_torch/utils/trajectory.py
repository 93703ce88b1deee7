"""Trajectory file writers/readers: TUM, EuRoC, KITTI formats.

Parity with the reference's SaveTrajectoryTUM / SaveTrajectoryEuRoC /
SaveTrajectoryKITTI output formats (ORB_SLAM3/src/System.cc:544+):
TUM = `ts tx ty tz qx qy qz qw`, EuRoC the same with ns timestamps and
comma separation is NOT used (space, like TUM), KITTI = 3x4 row-major pose.
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.utils.lie import SE3


def rot_to_quat(r: np.ndarray) -> np.ndarray:
    """(3,3) -> (x, y, z, w) quaternion."""
    m = r
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def save_tum(path: str, traj: list[tuple[float, SE3]]):
    with open(path, "w") as f:
        for ts, twc in traj:
            q = rot_to_quat(twc.R)
            t = twc.t
            f.write(
                f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def load_tum(path: str) -> list[tuple[float, SE3]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = np.array([float(x) for x in line.replace(",", " ").split()])
            out.append((v[0], SE3(quat_to_rot(v[4:8]), v[1:4])))
    return out


def save_kitti(path: str, traj: list[tuple[float, SE3]]):
    with open(path, "w") as f:
        for _, twc in traj:
            m = np.concatenate([twc.R, twc.t[:, None]], axis=1).ravel()
            f.write(" ".join(f"{v:.9e}" for v in m) + "\n")


def save_euroc(path: str, traj: list[tuple[float, SE3]]):
    """Reference SaveTrajectoryEuRoC artifact format
    (ORB_SLAM3/src/System.cc:634-745): nanosecond timestamps, then
    t and qx qy qz qw — the same quaternion order as TUM (the reference's
    own committed f_dataset-*.txt artifacts use it), NOT the EuRoC
    groundtruth csv's w-first order."""
    with open(path, "w") as f:
        for ts, twc in traj:
            q = rot_to_quat(twc.R)
            t = twc.t
            f.write(
                f"{ts * 1e9:.0f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )
