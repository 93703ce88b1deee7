"""Sim3 estimation between two keyframes: Horn closed form + RANSAC.

Role-parity with ORB_SLAM3/include/Sim3Solver.h:33-45 /
src/Sim3Solver.cc (489 LoC): from matched map-point pairs expressed in the
two camera frames, estimate (s, R, t) with Horn's absolute-orientation
closed form on 3-point samples, score by symmetric reprojection error,
iterate RANSAC (Sim3Solver::iterate).  `fix_scale=True` for stereo/RGBD.
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.utils.lie import Sim3, project_to_so3


def horn_sim3(p1: np.ndarray, p2: np.ndarray, fix_scale: bool = False) -> Sim3:
    """Closed-form similarity p1 = S12 * p2 (Horn 1987), N >= 3 points."""
    mu1, mu2 = p1.mean(0), p2.mean(0)
    x1, x2 = p1 - mu1, p2 - mu2
    cov = x1.T @ x2
    u, d, vt = np.linalg.svd(cov)
    sgn = np.sign(np.linalg.det(u @ vt))
    r = u @ np.diag([1.0, 1.0, sgn]) @ vt
    if fix_scale:
        s = 1.0
    else:
        num = (x1 * (x2 @ r.T)).sum()
        den = (x2 * x2).sum()
        s = num / max(den, 1e-12)
    t = mu1 - s * (r @ mu2)
    return Sim3(s, project_to_so3(r), t)


def sim3_ransac(
    p3d_c1: np.ndarray,
    p3d_c2: np.ndarray,
    cam1,
    cam2,
    sigma2_1: np.ndarray,
    sigma2_2: np.ndarray,
    fix_scale: bool,
    iterations: int = 300,
    min_inliers: int = 20,
    seed: int = 0,
):
    """Matched points in each camera frame -> (Sim3 c1<-c2 | None, inliers).

    Inlier test: project S12*p2 into cam1 and S12^-1*p1 into cam2, gate by
    chi2 9.210 * sigma2 (Sim3Solver::CheckInliers semantics)."""
    n = len(p3d_c1)
    if n < 3:
        return None, np.zeros(n, bool)
    rng = np.random.default_rng(seed)
    uv1 = cam1.project(p3d_c1)
    uv2 = cam2.project(p3d_c2)
    th1 = 9.210 * sigma2_1
    th2 = 9.210 * sigma2_2
    best, best_n = None, 0
    for _ in range(iterations):
        idx = rng.choice(n, 3, replace=False)
        if np.linalg.matrix_rank(p3d_c1[idx] - p3d_c1[idx].mean(0)) < 2:
            continue
        s12 = horn_sim3(p3d_c1[idx], p3d_c2[idx], fix_scale)
        if not (0.01 < s12.s < 100.0):
            continue
        p2in1 = s12.apply(p3d_c2)
        p1in2 = s12.inverse().apply(p3d_c1)
        ok = (p2in1[:, 2] > 0) & (p1in2[:, 2] > 0)
        e1 = ((cam1.project(np.where(ok[:, None], p2in1, [0, 0, 1])) - uv1) ** 2).sum(1)
        e2 = ((cam2.project(np.where(ok[:, None], p1in2, [0, 0, 1])) - uv2) ** 2).sum(1)
        inl = ok & (e1 < th1) & (e2 < th2)
        if inl.sum() > best_n:
            best_n = int(inl.sum())
            best = inl
            if best_n > 0.75 * n:
                break
    if best is None or best_n < min_inliers:
        return None, np.zeros(n, bool)
    s12 = horn_sim3(p3d_c1[best], p3d_c2[best], fix_scale)
    return s12, best
