"""Linear (DLT) triangulation, batched.

Analog of GeometricTools::Triangulate (ORB_SLAM3/include/
GeometricTools.h:40, src/GeometricTools.cc): for bearing observations
(x, y, 1) in two cameras with world-to-camera poses T1, T2, solve the
stacked cross-product constraints by SVD.  Vectorized over N points.
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.utils.lie import SE3


def triangulate_linear(
    kp_bearing1: np.ndarray,
    kp_bearing2: np.ndarray,
    T1: SE3,
    T2: SE3,
) -> np.ndarray:
    """(N, 3) world points from bearings (N, 3) and world->cam poses."""
    b1 = np.asarray(kp_bearing1, np.float64)
    b2 = np.asarray(kp_bearing2, np.float64)
    n = len(b1)
    p1 = np.concatenate([T1.R, T1.t.reshape(3, 1)], axis=1)  # (3, 4)
    p2 = np.concatenate([T2.R, T2.t.reshape(3, 1)], axis=1)
    a = np.empty((n, 4, 4))
    x1 = b1[:, 0] / b1[:, 2]
    y1 = b1[:, 1] / b1[:, 2]
    x2 = b2[:, 0] / b2[:, 2]
    y2 = b2[:, 1] / b2[:, 2]
    a[:, 0] = x1[:, None] * p1[2] - p1[0]
    a[:, 1] = y1[:, None] * p1[2] - p1[1]
    a[:, 2] = x2[:, None] * p2[2] - p2[0]
    a[:, 3] = y2[:, None] * p2[2] - p2[1]
    _, _, vt = np.linalg.svd(a)
    x = vt[:, 3]
    w = x[:, 3]
    w = np.where(np.abs(w) < 1e-12, 1e-12, w)
    return x[:, :3] / w[:, None]


def triangulate_linear_rows(
    kp_bearing1: np.ndarray,
    kp_bearing2: np.ndarray,
    R1: np.ndarray, t1: np.ndarray,
    R2: np.ndarray, t2: np.ndarray,
) -> np.ndarray:
    """Per-row-pose variant of triangulate_linear: poses (N, 3, 3)/(N, 3)
    differ per observation (fisheye dual-camera triangulation, where each
    match side may live in the left or the right camera of its rig —
    the reference's per-match sophTcw1/sophTcw2 selection,
    ORB_SLAM3/src/LocalMapping.cc:500-560)."""
    b1 = np.asarray(kp_bearing1, np.float64)
    b2 = np.asarray(kp_bearing2, np.float64)
    n = len(b1)
    p1 = np.concatenate([R1, t1[:, :, None]], axis=2)  # (N, 3, 4)
    p2 = np.concatenate([R2, t2[:, :, None]], axis=2)
    a = np.empty((n, 4, 4))
    x1 = b1[:, 0] / b1[:, 2]
    y1 = b1[:, 1] / b1[:, 2]
    x2 = b2[:, 0] / b2[:, 2]
    y2 = b2[:, 1] / b2[:, 2]
    a[:, 0] = x1[:, None] * p1[:, 2] - p1[:, 0]
    a[:, 1] = y1[:, None] * p1[:, 2] - p1[:, 1]
    a[:, 2] = x2[:, None] * p2[:, 2] - p2[:, 0]
    a[:, 3] = y2[:, None] * p2[:, 2] - p2[:, 1]
    _, _, vt = np.linalg.svd(a)
    x = vt[:, 3]
    w = x[:, 3]
    w = np.where(np.abs(w) < 1e-12, 1e-12, w)
    return x[:, :3] / w[:, None]
