"""Bundle adjustment: vectorized Schur-complement Levenberg-Marquardt.

Covers the visual BA flavours of the reference Optimizer facade —
LocalBundleAdjustment (ORB_SLAM3/src/Optimizer2.cc:350),
GlobalBundleAdjustemnt/BundleAdjustment (Optimizer1.cc:48,56) — with the
same residual model as pose_optimization (mono 2-dof + stereo 3-dof
reprojection, Huber deltas sqrt(5.991)/sqrt(7.815), per-octave information)
over many poses and points, some poses held fixed.

Not a g2o port: the whole pipeline is array programs —
 - residuals/Jacobians for ALL observations in one batch;
 - camera 6x6 blocks, point 3x3 blocks, and 6x3 couplings by scatter-add;
 - Schur cross-terms grouped by per-point observer count so every bucket is
   one einsum (no per-point Python loop);
 - the reduced camera system is dense (local windows are <= tens of poses).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from orbslam3_tpu_torch.utils.lie import SE3, hat

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class AbortFlag:
    """Cross-thread BA interrupt (the reference's LocalMapping::mbAbortBA
    consumed by g2o's setForceStopFlag, ORB_SLAM3/src/
    LocalMapping.cc:288 + Optimizer2.cc): a single shared byte the tracker
    sets when it inserts a keyframe so a running local BA returns its
    partial result instead of making the tracker wait.

    Backed by a 1-byte NumPy buffer so the native ba_schur loop (which runs
    with the GIL released) can poll the same memory the Python side sets."""

    __slots__ = ("buf",)

    def __init__(self):
        self.buf = np.zeros(1, np.uint8)

    def set(self):
        self.buf[0] = 1

    def clear(self):
        self.buf[0] = 0

    def __bool__(self) -> bool:
        return bool(self.buf[0])


@dataclass
class BAProblem:
    """Observation soup for BA.

    cam_idx, pt_idx: (O,) int — which pose/point each observation binds.
    obs_uv: (O, 2); obs_ur: (O,) (<0 = mono); inv_sigma2: (O,).
    poses: list[SE3] world->cam; points: (P, 3) world.
    fixed_cams: bool (C,) — poses not updated.
    camera: shared GeometricCamera; mbf: stereo baseline*fx.
    """

    poses: list
    points: np.ndarray
    cam_idx: np.ndarray
    pt_idx: np.ndarray
    obs_uv: np.ndarray
    obs_ur: np.ndarray
    inv_sigma2: np.ndarray
    fixed_cams: np.ndarray
    camera: object
    mbf: float
    # fisheye dual-camera observations: right rows project through
    # Trl + camera2 (EdgeSE3ProjectXYZToBody, include/OptimizableTypes.h:117)
    is_right: np.ndarray | None = None
    camera2: object = None
    Trl: object = None


def _pack(poses):
    r = np.stack([p.R for p in poses])
    t = np.stack([p.t for p in poses])
    return r, t


def _project_rows(pc, pr):
    """Per-row projection (left rows: camera; right rows: Trl then camera2,
    with Trl.R folded into the returned Jacobian by the chain rule)."""
    ir = getattr(pr, "is_right", None)
    if ir is None or not ir.any():
        return pr.camera.project(pc), pr.camera.project_jac(pc)
    n = len(pc)
    uv = np.empty((n, 2))
    jp = np.empty((n, 2, 3))
    il = ~ir
    if il.any():
        uv[il] = pr.camera.project(pc[il])
        jp[il] = pr.camera.project_jac(pc[il])
    r2, t2 = pr.Trl.R, pr.Trl.t
    pc_r = pc[ir] @ r2.T + t2
    uv[ir] = pr.camera2.project(pc_r)
    jp[ir] = pr.camera2.project_jac(pc_r) @ r2
    return uv, jp


def _residuals_jacs(r, t, points, pr):
    """All-observation residuals (O, 3) and Jacobians (O, 3, 6), (O, 3, 3)."""
    rc = r[pr.cam_idx]                       # (O, 3, 3)
    tc = t[pr.cam_idx]
    pw = points[pr.pt_idx]
    pc = (rc @ pw[..., None])[..., 0] + tc   # (O, 3)
    uv, jproj = _project_rows(pc, pr)
    res_uv = pr.obs_uv - uv
    stereo = pr.obs_ur >= 0
    z = np.maximum(pc[:, 2], 1e-9)
    ur_pred = uv[:, 0] - pr.mbf / z
    res_ur = np.where(stereo, pr.obs_ur - ur_pred, 0.0)
    res = np.concatenate([res_uv, res_ur[:, None]], axis=1)

    o = len(pc)
    dpc_dxi = np.concatenate(
        [np.broadcast_to(np.eye(3), (o, 3, 3)), -hat(pc)], axis=2
    )                                        # (O, 3, 6) left-increment
    j_uv_c = jproj @ dpc_dxi                 # (O, 2, 6)
    j_uv_p = jproj @ rc                      # (O, 2, 3)
    dz_c = dpc_dxi[:, 2, :]
    dz_p = rc[:, 2, :]
    mz = (pr.mbf / (z * z))[:, None]
    j_ur_c = np.where(stereo[:, None], j_uv_c[:, 0, :] + mz * dz_c, 0.0)
    j_ur_p = np.where(stereo[:, None], j_uv_p[:, 0, :] + mz * dz_p, 0.0)
    jc = np.concatenate([j_uv_c, j_ur_c[:, None, :]], axis=1)  # (O, 3, 6)
    jp = np.concatenate([j_uv_p, j_ur_p[:, None, :]], axis=1)  # (O, 3, 3)
    # res = obs - pred; jacobians below are d pred, so d res = -J
    return res, -jc, -jp, stereo


def _chi2(res, inv_sigma2, stereo):
    e2 = np.where(stereo, (res * res).sum(1), (res[:, :2] ** 2).sum(1))
    return e2 * inv_sigma2


def _weights(res, pr, stereo, use_huber):
    chi2 = _chi2(res, pr.inv_sigma2, stereo)
    if not use_huber:
        return pr.inv_sigma2, chi2
    delta = np.where(stereo, np.sqrt(CHI2_STEREO), np.sqrt(CHI2_MONO))
    e = np.sqrt(np.maximum(chi2, 1e-18))
    w = np.where(e <= delta, 1.0, delta / e)
    return pr.inv_sigma2 * w, chi2


def _robust_cost(chi2, stereo, use_huber, active):
    if not use_huber:
        return float(chi2[active].sum())
    delta2 = np.where(stereo, CHI2_STEREO, CHI2_MONO)
    delta = np.sqrt(delta2)
    e = np.sqrt(np.maximum(chi2, 0))
    rho = np.where(e <= delta, chi2, 2 * delta * e - delta2)
    return float(rho[active].sum())


def bundle_adjust(
    pr: BAProblem,
    n_iters: int = 10,
    use_huber: bool = True,
    active: np.ndarray | None = None,
    abort_flag: AbortFlag | None = None,
):
    """LM with Schur complement.  Returns (poses, points, final chi2 (O,)).

    Dispatches to the native C++ port (orbslam3_native.cpp ba_schur — same
    damping, Schur reduction, and trial-step schedule; runs the local-BA
    window in tens of ms where the NumPy loop takes seconds) for pinhole
    cameras; the NumPy path remains the spec and the fallback (and the only
    path for fisheye)."""
    from orbslam3_tpu_torch.cameras.models import Pinhole

    # native path iff the projection IS pinhole math (Pinhole.project never
    # applies distortion — coefficients only drive keypoint undistortion);
    # `no_native = True` on the camera opts out explicitly (tests use it to
    # force the NumPy spec path)
    use_native = (
        isinstance(pr.camera, Pinhole)
        and not getattr(pr.camera, "no_native", False)
        and len(pr.cam_idx)
        and (pr.is_right is None or not pr.is_right.any())
    )
    if use_native:
        from orbslam3_tpu_torch import native

        if native.available():
            act = (
                np.ones(len(pr.cam_idx), bool) if active is None else active
            )
            pose_blk = np.concatenate(
                [
                    np.stack([p.R.reshape(9) for p in pr.poses]),
                    np.stack([p.t for p in pr.poses]),
                ],
                axis=1,
            )
            out = native.ba_schur(
                pose_blk, pr.points, pr.cam_idx, pr.pt_idx, pr.obs_uv,
                pr.obs_ur, pr.inv_sigma2, pr.fixed_cams, act,
                pr.camera.fx, pr.camera.fy, pr.camera.cx, pr.camera.cy,
                pr.mbf, n_iters, use_huber,
                abort_buf=abort_flag.buf if abort_flag is not None else None,
            )
            if out is not None:
                poses_b, points, chi2 = out
                poses = [
                    SE3(row[:9].reshape(3, 3), row[9:]).normalized()
                    for row in poses_b
                ]
                return poses, points, chi2
    n_c = len(pr.poses)
    n_p = len(pr.points)
    r, t = _pack(pr.poses)
    points = pr.points.copy()
    free = ~pr.fixed_cams
    free_idx = np.nonzero(free)[0]
    c_slot = np.full(n_c, -1)
    c_slot[free_idx] = np.arange(len(free_idx))
    n_free = len(free_idx)
    if active is None:
        active = np.ones(len(pr.cam_idx), bool)

    # group observations by point for Schur cross terms (bucket by count)
    order = np.argsort(pr.pt_idx, kind="stable")
    sorted_pt = pr.pt_idx[order]
    starts = np.searchsorted(sorted_pt, np.arange(n_p + 1))

    lam = 1e-5
    res, jc, jp, stereo = _residuals_jacs(r, t, points, pr)
    w, chi2 = _weights(res, pr, stereo, use_huber)
    cost = _robust_cost(chi2, stereo, use_huber, active)

    for _ in range(n_iters):
        if abort_flag is not None and abort_flag:
            break  # interrupted by a keyframe insertion / stop request
        res, jc, jp, stereo = _residuals_jacs(r, t, points, pr)
        w, chi2 = _weights(res, pr, stereo, use_huber)
        wa = np.where(active, w, 0.0)

        jcw = jc * wa[:, None, None]
        a_blk = np.einsum("ori,orj->oij", jcw, jc)        # (O, 6, 6)
        b_blk = np.einsum("ori,orj->oij", jp * wa[:, None, None], jp)  # (O,3,3)
        w_blk = np.einsum("ori,orj->oij", jcw, jp)        # (O, 6, 3)
        bc_blk = np.einsum("ori,or->oi", jcw, res)        # (O, 6)
        bp_blk = np.einsum("ori,or->oi", jp * wa[:, None, None], res)  # (O, 3)

        h_cc = np.zeros((n_c, 6, 6))
        np.add.at(h_cc, pr.cam_idx, a_blk)
        h_pp = np.zeros((n_p, 3, 3))
        np.add.at(h_pp, pr.pt_idx, b_blk)
        g_c = np.zeros((n_c, 6))
        np.add.at(g_c, pr.cam_idx, bc_blk)
        g_p = np.zeros((n_p, 3))
        np.add.at(g_p, pr.pt_idx, bp_blk)

        # LM damping
        h_pp_d = h_pp + lam * np.eye(3) * np.maximum(
            np.abs(np.diagonal(h_pp, axis1=1, axis2=2))[:, :, None] * np.eye(3), 1e-9
        )
        vinv = np.linalg.inv(h_pp_d + 1e-12 * np.eye(3))

        s = np.zeros((n_free * 6, n_free * 6))
        rhs = np.zeros(n_free * 6)
        for ci in free_idx:
            sl = c_slot[ci]
            s[sl * 6 : sl * 6 + 6, sl * 6 : sl * 6 + 6] = h_cc[ci]
            rhs[sl * 6 : sl * 6 + 6] = -g_c[ci]
        s += lam * np.diag(np.maximum(np.diag(s), 1e-9))

        # Schur: bucket points by observer count
        cnt = starts[1:] - starts[:-1]
        y_all = np.einsum("oij,ojk->oik", w_blk, vinv[pr.pt_idx])  # (O, 6, 3)
        # rhs -= Y g_p  (per obs, gathered to its cam)
        ygp = np.einsum("oij,oj->oi", y_all, g_p[pr.pt_idx])
        for ci in free_idx:
            sl = c_slot[ci]
            m = (pr.cam_idx == ci)
            rhs[sl * 6 : sl * 6 + 6] += ygp[m].sum(0)
        for k in range(2, int(cnt.max(initial=1)) + 1):
            pts_k = np.nonzero(cnt == k)[0]
            if len(pts_k) == 0:
                continue
            # (Pk, k) observation rows per point
            rows = starts[pts_k][:, None] + np.arange(k)[None, :]
            obs_k = order[rows]                               # (Pk, k)
            cams_k = pr.cam_idx[obs_k]                        # (Pk, k)
            y_k = y_all[obs_k]                                # (Pk, k, 6, 3)
            w_k = w_blk[obs_k]                                # (Pk, k, 6, 3)
            cross = np.einsum("paij,pbkj->pabik", y_k, w_k)   # (Pk, k, k, 6, 6)
            sa = c_slot[cams_k]                               # (Pk, k)
            valid = sa >= 0
            pa = np.broadcast_to(sa[:, :, None], cross.shape[:3])
            pb = np.broadcast_to(sa[:, None, :], cross.shape[:3])
            ok = np.broadcast_to(valid[:, :, None], cross.shape[:3]) & np.broadcast_to(
                valid[:, None, :], cross.shape[:3]
            )
            ia = pa[ok]
            ib = pb[ok]
            blocks = cross[ok]                                # (nb, 6, 6)
            ii = (ia[:, None] * 6 + np.arange(6)[None, :])[:, :, None]
            jj = (ib[:, None] * 6 + np.arange(6)[None, :])[:, None, :]
            np.subtract.at(s, (np.broadcast_to(ii, blocks.shape),
                               np.broadcast_to(jj, blocks.shape)), blocks)
        # single-observer points have no cross terms beyond their own cam
        # (handled in the k loop starting at 2? no: k=1 has a self term)
        pts_1 = np.nonzero(cnt == 1)[0]
        if len(pts_1):
            rows = starts[pts_1]
            obs_1 = order[rows]
            cams_1 = pr.cam_idx[obs_1]
            y_1 = y_all[obs_1]
            w_1 = w_blk[obs_1]
            cross = np.einsum("pij,pkj->pik", y_1, w_1)
            sa = c_slot[cams_1]
            m = sa >= 0
            ia = sa[m]
            blocks = cross[m]
            ii = (ia[:, None] * 6 + np.arange(6)[None, :])[:, :, None]
            jj = (ia[:, None] * 6 + np.arange(6)[None, :])[:, None, :]
            np.subtract.at(s, (np.broadcast_to(ii, blocks.shape),
                               np.broadcast_to(jj, blocks.shape)), blocks)

        try:
            dx_c = np.linalg.solve(s + 1e-12 * np.eye(len(s)), rhs)
        except np.linalg.LinAlgError:
            lam *= 10
            continue

        # back-substitute points: dp = Vinv (-g_p - W^T dxc)
        wtdx = np.zeros((n_p, 3))
        sl_all = c_slot[pr.cam_idx]
        has_free = sl_all >= 0
        dxc_per_obs = np.zeros((len(pr.cam_idx), 6))
        dxc_per_obs[has_free] = dx_c.reshape(n_free, 6)[sl_all[has_free]]
        wt_contrib = np.einsum("oij,oi->oj", w_blk, dxc_per_obs)
        np.add.at(wtdx, pr.pt_idx, wt_contrib)
        dp = np.einsum("pij,pj->pi", vinv, -g_p - wtdx)

        # apply tentative update
        r_new, t_new = r.copy(), t.copy()
        for ci in free_idx:
            sl = c_slot[ci]
            upd = SE3.exp(dx_c[sl * 6 : sl * 6 + 6]) * SE3(r[ci], t[ci])
            r_new[ci], t_new[ci] = upd.R, upd.t
        pts_new = points + dp

        res_n, _, _, st_n = _residuals_jacs(r_new, t_new, pts_new, pr)
        _, chi2_n = _weights(res_n, pr, st_n, use_huber)
        cost_n = _robust_cost(chi2_n, st_n, use_huber, active)
        if cost_n < cost:
            r, t, points = r_new, t_new, pts_new
            cost = cost_n
            lam = max(lam / 3, 1e-9)
        else:
            lam *= 10

    res, _, _, stereo = _residuals_jacs(r, t, points, pr)
    chi2 = _chi2(res, pr.inv_sigma2, stereo)
    poses_out = [SE3(r[i], t[i]) for i in range(n_c)]
    return poses_out, points, chi2
