"""Per-frame pose-only optimization (motion-only bundle adjustment).

Semantics follow Optimizer::PoseOptimization (ORB_SLAM3/src/
Optimizer2.cc:48): a single SE3 vertex, one unary reprojection edge per
matched map point (mono 2-dof or stereo 3-dof with the virtual right-u
residual), Huber kernels with delta = sqrt(5.991) / sqrt(7.815), four
optimization rounds of 10 iterations each, chi2 outlier re-classification
between rounds (outliers excluded from the next round, re-included if their
chi2 recovers), robust kernel dropped after round 2.

Implementation is a dense vectorized Levenberg-Marquardt on the 6-dof
left-multiplicative increment — NOT a g2o translation: the whole residual/
Jacobian/normal-equation stack is one batch of NumPy array ops (the
reference loops per-edge through g2o's virtual dispatch).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from orbslam3_tpu_torch.utils.lie import SE3, hat

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


@dataclass
class PoseObservations:
    """Matched observations for one frame (already associated to map points).

    `is_right`/`camera2`/`Trl` carry fisheye right-camera observations: a
    right row's residual is obs - camera2.project(Trl * (Tcw * Xw)) — the
    reference's EdgeSE3ProjectXYZOnlyPoseToBody
    (ORB_SLAM3/include/OptimizableTypes.h:59)."""

    p3d_w: np.ndarray        # (N, 2) world points
    obs_uv: np.ndarray       # (N, 2) keypoint pixels (undistorted)
    obs_ur: np.ndarray       # (N,) right-u for stereo obs, <0 if mono
    inv_sigma2: np.ndarray   # (N,) per-obs information (by octave)
    camera: object           # GeometricCamera
    mbf: float = 0.0
    is_right: np.ndarray | None = None  # (N,) bool — right-camera obs
    camera2: object = None
    Trl: SE3 | None = None   # left camera -> right camera


def _project_rows(pc: np.ndarray, o):
    """Per-row projection: left rows through `camera`, right rows through
    Trl + `camera2` (chain rule folds Trl.R into the projection Jacobian,
    matching EdgeSE3ProjectXYZ(OnlyPose)ToBody::linearizeOplus).
    Returns (uv (N,2), jproj (N,2,3) wrt the LEFT-camera point pc)."""
    ir = getattr(o, "is_right", None)
    if ir is None or not ir.any():
        return o.camera.project(pc), o.camera.project_jac(pc)
    n = len(pc)
    uv = np.empty((n, 2))
    jp = np.empty((n, 2, 3))
    il = ~ir
    if il.any():
        uv[il] = o.camera.project(pc[il])
        jp[il] = o.camera.project_jac(pc[il])
    r2, t2 = o.Trl.R, o.Trl.t
    pc_r = pc[ir] @ r2.T + t2
    uv[ir] = o.camera2.project(pc_r)
    jp[ir] = o.camera2.project_jac(pc_r) @ r2
    return uv, jp


def _residuals_jac(T: SE3, o: PoseObservations):
    """Residuals (N, 3) [du, dv, dur] with dur=0 for mono, plus (N, 3, 6) J."""
    pc = o.p3d_w @ T.R.T + T.t
    uv, jproj = _project_rows(pc, o)
    r_uv = o.obs_uv - uv
    stereo = o.obs_ur >= 0
    z = pc[:, 2]
    ur_pred = uv[:, 0] - o.mbf / np.maximum(z, 1e-9)
    r_ur = np.where(stereo, o.obs_ur - ur_pred, 0.0)
    res = np.concatenate([r_uv, r_ur[:, None]], axis=1)  # (N, 3)

    # d pc / d xi (left increment): [I | -hat(pc)]
    dpc = np.concatenate(
        [np.broadcast_to(np.eye(3), (len(pc), 3, 3)), -hat(pc)], axis=2
    )  # (N, 3, 6)
    j_uv = jproj @ dpc  # (N, 2, 6)
    # ur = u - mbf/z -> d ur = d u + mbf/z^2 * d z
    dz = dpc[:, 2, :]  # (N, 6)
    j_ur = j_uv[:, 0, :] + (o.mbf / np.maximum(z, 1e-9) ** 2)[:, None] * dz
    j_ur = np.where(stereo[:, None], j_ur, 0.0)
    jac = np.concatenate([j_uv, j_ur[:, None, :]], axis=1)  # (N, 3, 6)
    # error convention: res = obs - pred, d res / d xi = -J
    return res, -jac, stereo


# Graduated robustification: round r uses a Huber delta scaled by
# _DELTA_SCALE[r] and classifies outliers at chi2 * _CHI2_SCALE[r].  The
# reference keeps both constant (Optimizer2.cc chi2Mono = {5.991 x4});
# annealing widens the basin of attraction under structured outliers
# (drift-consistent VO points / aliased matches) without changing the
# final-round acceptance criterion.
_DELTA_SCALE = (3.0, 1.5, 1.0, 1.0)
_CHI2_SCALE = (6.0, 2.5, 1.0, 1.0)


def pose_optimization(
    T_init: SE3, obs: PoseObservations, n_rounds: int = 4, n_iters: int = 10
) -> tuple[SE3, np.ndarray, int]:
    """Returns (optimized pose, inlier mask, n_inliers).

    Dispatches to the native C++ port (orbslam3_native.cpp pose_optimize —
    same LM schedule, Huber annealing, and reclassification; <1 ms vs
    ~45 ms for the NumPy loop at 600 points) for pinhole cameras; the
    NumPy path remains the spec and the fallback (and the only path for
    fisheye frames, whose projection lives in Python)."""
    n = len(obs.p3d_w)
    if n < 3:
        return T_init.copy(), np.zeros(n, bool), 0
    if type(obs.camera).__name__ == "Pinhole" and (
        obs.is_right is None or not obs.is_right.any()
    ):
        from orbslam3_tpu_torch import native

        res = (
            native.pose_optimize(
                obs.p3d_w, obs.obs_uv, obs.obs_ur, obs.inv_sigma2,
                obs.camera.fx, obs.camera.fy, obs.camera.cx, obs.camera.cy,
                obs.mbf, T_init.R, T_init.t, n_rounds, n_iters,
            )
            if native.available()
            else None
        )
        if res is not None:
            R, t, inlier, n_in = res
            return SE3(R, t).normalized(), inlier, n_in
    T = T_init.copy()
    stereo = obs.obs_ur >= 0
    chi2_base = np.where(stereo, CHI2_STEREO, CHI2_MONO)
    inlier = np.ones(n, bool)

    for rnd in range(n_rounds):
        use_huber = rnd < 3
        chi2_th = chi2_base * _CHI2_SCALE[min(rnd, len(_CHI2_SCALE) - 1)]
        delta = np.sqrt(chi2_base) * _DELTA_SCALE[min(rnd, len(_DELTA_SCALE) - 1)]
        lam = 1e-4
        T_rnd = T.copy()
        res, jac, _ = _residuals_jac(T_rnd, obs)
        cost_prev = _robust_cost(res, obs.inv_sigma2, inlier, delta, use_huber, stereo)
        for _ in range(n_iters):
            res, jac, _ = _residuals_jac(T_rnd, obs)
            w = _irls_weights(res, obs.inv_sigma2, delta, use_huber, stereo)
            w = np.where(inlier, w, 0.0)
            # normal equations over the 3 residual rows
            jw = jac * w[:, None, None]
            h = np.einsum("nri,nrj->ij", jw, jac)
            b = np.einsum("nri,nr->i", jw, res)
            # note: res = obs-pred and jac = d res/d xi, so step solves H dx = -b
            ok_step = False
            for _ in range(8):
                try:
                    dx = np.linalg.solve(h + lam * np.diag(np.diag(h)) + 1e-12 * np.eye(6), -b)
                except np.linalg.LinAlgError:
                    lam *= 10
                    continue
                T_new = SE3.exp(dx) * T_rnd
                res_new, _, _ = _residuals_jac(T_new, obs)
                cost_new = _robust_cost(res_new, obs.inv_sigma2, inlier, delta, use_huber, stereo)
                if cost_new < cost_prev:
                    T_rnd = T_new
                    cost_prev = cost_new
                    lam = max(lam / 3, 1e-9)
                    ok_step = True
                    break
                lam *= 10
            if not ok_step:
                break
        T = T_rnd
        # chi2 re-classification (all edges, g2o-style)
        res, _, _ = _residuals_jac(T, obs)
        chi2 = _chi2(res, obs.inv_sigma2, stereo)
        inlier = chi2 <= chi2_th
        if inlier.sum() < 10:
            break
    return T, inlier, int(inlier.sum())


def _chi2(res, inv_sigma2, stereo):
    e2 = np.where(stereo, (res * res).sum(axis=1), (res[:, :2] ** 2).sum(axis=1))
    return e2 * inv_sigma2


def _irls_weights(res, inv_sigma2, delta, use_huber, stereo):
    chi2 = _chi2(res, inv_sigma2, stereo)
    if not use_huber:
        return inv_sigma2
    e = np.sqrt(np.maximum(chi2, 1e-18))
    scale = np.where(e <= delta, 1.0, delta / e)
    return inv_sigma2 * scale


def _robust_cost(res, inv_sigma2, inlier, delta, use_huber, stereo):
    chi2 = _chi2(res, inv_sigma2, stereo)
    if use_huber:
        e = np.sqrt(np.maximum(chi2, 0))
        rho = np.where(e <= delta, chi2, 2 * delta * e - delta * delta)
    else:
        rho = chi2
    return float(np.sum(rho[inlier]))
