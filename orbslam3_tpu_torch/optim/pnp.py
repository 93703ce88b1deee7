"""RANSAC PnP for relocalization: MLPnP with EPnP fallback.

Role-parity with the reference's MLPnPsolver (ORB_SLAM3/include/
MLPnPsolver.h:59-72, 1,056 LoC — RANSAC around the ML-PnP algorithm of
Urban et al. 2016).  The ML formulation here matches the reference's:
observations become unit BEARING vectors with a 2D tangent-space nullspace
basis [r s] per bearing; the pose solves the nullspace constraint
[r s]^T (R p + t) = 0 by DLT over the 12 pose parameters, orthogonalized
via SVD, then refined by Gauss-Newton on the nullspace residuals (the
bearing-covariance weighting reduces to the per-keypoint inv_sigma2 the
pipeline already carries).  Coplanar worlds (rank-deficient DLT) route to
a plane-homography decomposition — the reference MLPnPsolver's planar
branch role — with EPnP (Lepetit et al.) retained as a general fallback.
All run inside one RANSAC + inlier-refinement loop.
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.utils.lie import SE3, project_to_so3


def _nullspace_basis(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, 3) unit bearings -> (N, 3) r and (N, 3) s with {r, s, v}
    orthonormal (MLPnPsolver::nullspace role)."""
    # pick the axis least aligned with v for a stable cross product
    pick = np.abs(v).argmin(axis=1)
    e = np.zeros_like(v)
    e[np.arange(len(v)), pick] = 1.0
    r = np.cross(v, e)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    s = np.cross(v, r)
    return r, s


def _mlpnp(pw: np.ndarray, bear: np.ndarray, refine_iters: int = 5) -> SE3 | None:
    """MLPnP DLT + GN refinement for n >= 6 NON-planar points.

    bear: (N, 3) unit bearing vectors of the observations."""
    n = len(pw)
    r, s = _nullspace_basis(bear)
    # DLT over x = [vec(R) rows; t]: [r|s]^T (R p + t) = 0
    a = np.zeros((2 * n, 12))
    for k, nv in enumerate((r, s)):
        # row: nv . (R p) + nv . t = sum_j nv_i * R_ij * p_j
        a[k::2, 0:3] = nv[:, 0:1] * pw
        a[k::2, 3:6] = nv[:, 1:2] * pw
        a[k::2, 6:9] = nv[:, 2:3] * pw
        a[k::2, 9:12] = nv
    _, sv, vt = np.linalg.svd(a, full_matrices=False)
    x = vt[-1]
    r_raw = x[:9].reshape(3, 3)
    t_raw = x[9:12]
    # scale from the rotation's norm; sign from cheirality
    scale = np.cbrt(np.linalg.det(r_raw)) if np.linalg.det(r_raw) > 0 else None
    if scale is None or abs(scale) < 1e-12:
        # try the opposite sign
        r_raw, t_raw = -r_raw, -t_raw
        det = np.linalg.det(r_raw)
        if det <= 1e-18:
            return None
        scale = np.cbrt(det)
    rot = project_to_so3(r_raw / scale)
    t = t_raw / scale
    pc = pw @ rot.T + t
    if np.median(pc[:, 2]) < 0:
        # bearings have positive depth along v by construction; flip
        rot = project_to_so3(-r_raw / scale)
        t = -t_raw / scale
    T = SE3(rot, t)
    # GN refinement on the nullspace residuals e = [r s]^T (R p + t)/|.|
    eps = 1e-6
    for _ in range(refine_iters):
        def res(Tc):
            pc = Tc.apply(pw)
            pcn = pc / np.linalg.norm(pc, axis=1, keepdims=True)
            return np.concatenate([(r * pcn).sum(1), (s * pcn).sum(1)])

        r0 = res(T)
        jac = np.empty((2 * n, 6))
        for k in range(6):
            d = np.zeros(6)
            d[k] = eps
            jac[:, k] = (res(SE3.exp(d) * T) - res(SE3.exp(-d) * T)) / (2 * eps)
        h = jac.T @ jac + 1e-12 * np.eye(6)
        try:
            dx = np.linalg.solve(h, -(jac.T @ r0))
        except np.linalg.LinAlgError:
            break
        T = (SE3.exp(dx) * T).normalized()
        if np.linalg.norm(dx) < 1e-10:
            break
    return T


def _is_planar(pw: np.ndarray) -> bool:
    a = pw - pw.mean(axis=0)
    sv = np.linalg.svd(a, compute_uv=False)
    return sv[2] < 1e-3 * max(sv[0], 1e-12)


def _planar_pnp(pw: np.ndarray, uv_n: np.ndarray) -> SE3 | None:
    """Coplanar-world pose via plane-to-image homography decomposition
    (the reference MLPnPsolver's planar branch role): express points in a
    plane frame, DLT the homography to normalized image coords, recover
    [r1 r2 t] from its columns."""
    n = len(pw)
    c0 = pw.mean(axis=0)
    a = pw - c0
    _, _, vt = np.linalg.svd(a, full_matrices=False)
    basis = vt[:2].T  # (3, 2) in-plane axes
    xy = a @ basis    # (n, 2) plane coordinates
    m = np.zeros((2 * n, 9))
    m[0::2, 0:2] = xy
    m[0::2, 2] = 1.0
    m[0::2, 6:8] = -xy * uv_n[:, 0:1]
    m[0::2, 8] = -uv_n[:, 0]
    m[1::2, 3:5] = xy
    m[1::2, 5] = 1.0
    m[1::2, 6:8] = -xy * uv_n[:, 1:2]
    m[1::2, 8] = -uv_n[:, 1]
    _, _, vth = np.linalg.svd(m, full_matrices=False)
    h = vth[-1].reshape(3, 3)
    n1, n2 = np.linalg.norm(h[:, 0]), np.linalg.norm(h[:, 1])
    if n1 < 1e-12 or n2 < 1e-12:
        return None
    lam = 2.0 / (n1 + n2)
    r1 = h[:, 0] * lam
    r2 = h[:, 1] * lam
    t = h[:, 2] * lam
    r3 = np.cross(r1, r2)
    rp = project_to_so3(np.stack([r1, r2, r3], axis=1))
    # cheirality: points must be in front
    p3 = np.concatenate([xy, np.zeros((n, 1))], axis=1)
    z = (p3 @ rp.T + t)[:, 2]
    if np.median(z) < 0:
        rp = project_to_so3(np.stack([-r1, -r2, np.cross(-r1, -r2)], axis=1))
        t = -t
    # back to world coords: x_c = Rp * B^T (p - c0) + t = R p + t_full
    b3 = np.concatenate([basis, np.cross(basis[:, 0], basis[:, 1])[:, None]], axis=1)
    rot = rp @ b3.T
    t_full = t - rot @ c0
    return SE3(project_to_so3(rot), t_full)


def _epnp(pw: np.ndarray, uv_n: np.ndarray) -> SE3 | None:
    """EPnP for n >= 4 points; uv_n are normalized image coords (x, y)."""
    n = len(pw)
    # control points: centroid + principal axes
    c0 = pw.mean(axis=0)
    a = pw - c0
    cov = a.T @ a / n
    w_, v_ = np.linalg.eigh(cov)
    ctrl = np.vstack([c0, c0 + v_.T * np.sqrt(np.maximum(w_, 1e-12))[:, None]])
    # barycentric coordinates
    m = np.vstack([ctrl.T, np.ones(4)])  # (4, 4)
    try:
        alphas = np.linalg.solve(m, np.vstack([pw.T, np.ones(n)])).T  # (n, 4)
    except np.linalg.LinAlgError:
        return None
    # build M (2n x 12)
    mm = np.zeros((2 * n, 12))
    for j in range(4):
        mm[0::2, 3 * j] = alphas[:, j]
        mm[0::2, 3 * j + 2] = -alphas[:, j] * uv_n[:, 0]
        mm[1::2, 3 * j + 1] = alphas[:, j]
        mm[1::2, 3 * j + 2] = -alphas[:, j] * uv_n[:, 1]
    _, _, vt = np.linalg.svd(mm, full_matrices=False)
    cc = vt[-1].reshape(4, 3)  # control points in camera frame (up to scale)
    # fix scale/sign via distances between control points
    d_w = np.linalg.norm(ctrl[1:] - ctrl[0], axis=1)
    d_c = np.linalg.norm(cc[1:] - cc[0], axis=1)
    if d_c.sum() < 1e-12:
        return None
    s = d_w.sum() / d_c.sum()
    cc = cc * s
    pc = alphas @ cc
    if np.median(pc[:, 2]) < 0:
        pc = -pc
    # Procrustes: world -> camera rigid transform
    mu_w, mu_c = pw.mean(0), pc.mean(0)
    h = (pw - mu_w).T @ (pc - mu_c)
    u, _, vt2 = np.linalg.svd(h)
    r = vt2.T @ np.diag([1, 1, np.sign(np.linalg.det(vt2.T @ u.T))]) @ u.T
    t = mu_c - r @ mu_w
    return SE3(project_to_so3(r), t)


def pnp_ransac(
    pw: np.ndarray,
    uv: np.ndarray,
    camera,
    inv_sigma2: np.ndarray | None = None,
    iterations: int = 200,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
    seed: int = 0,
):
    """Returns (SE3 | None, inlier mask).  pw (N,3) world, uv (N,2) pixels."""
    n = len(pw)
    if n < 6:
        return None, np.zeros(n, bool)
    if inv_sigma2 is None:
        inv_sigma2 = np.ones(n)
    rays = camera.unproject(uv)
    uv_n = rays[:, :2] / rays[:, 2:3]
    bear = rays / np.linalg.norm(rays, axis=1, keepdims=True)
    rng = np.random.default_rng(seed)
    best_inl = None
    best_n = 0
    planar = _is_planar(pw)
    for _ in range(iterations):
        idx = rng.choice(n, 6, replace=False)
        if planar or _is_planar(pw[idx]):
            T = _planar_pnp(pw[idx], uv_n[idx])
        else:
            T = _mlpnp(pw[idx], bear[idx], refine_iters=2)
        if T is None:
            continue
        pc = T.apply(pw)
        ok_z = pc[:, 2] > 0.05
        proj = camera.project(np.where(ok_z[:, None], pc, [0, 0, 1.0]))
        e2 = ((proj - uv) ** 2).sum(axis=1) * inv_sigma2
        inl = ok_z & (e2 < chi2_th)
        if inl.sum() > best_n:
            best_n = int(inl.sum())
            best_inl = inl
            if best_n > 0.8 * n:
                break
    if best_inl is None or best_n < min_inliers:
        return None, np.zeros(n, bool)
    # refine on inliers (full ML refinement pass)
    if planar or _is_planar(pw[best_inl]):
        T = _planar_pnp(pw[best_inl], uv_n[best_inl])
    else:
        T = _mlpnp(pw[best_inl], bear[best_inl], refine_iters=6)
    if T is None:
        T = _epnp(pw[best_inl], uv_n[best_inl])
    if T is None:
        return None, np.zeros(n, bool)
    pc = T.apply(pw)
    ok_z = pc[:, 2] > 0.05
    proj = camera.project(np.where(ok_z[:, None], pc, [0, 0, 1.0]))
    e2 = ((proj - uv) ** 2).sum(axis=1) * inv_sigma2
    inl = ok_z & (e2 < chi2_th)
    if inl.sum() < min_inliers:
        return None, np.zeros(n, bool)
    return T, inl
