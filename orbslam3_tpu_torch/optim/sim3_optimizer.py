"""Nonlinear Sim3 refinement with inlier reclassification.

Role-parity with Optimizer::OptimizeSim3 (ORB_SLAM3/src/
Optimizer3.cc:662): given matched map-point pairs between two keyframes and
an initial relative Sim3 S12 (from Sim3Solver RANSAC), minimize the
symmetric reprojection error

    e1 = proj_cam1(S12   * x2)  - obs1     (x2 = point in cam-2 frame)
    e2 = proj_cam2(S12^-1 * x1) - obs2     (x1 = point in cam-1 frame)

over the 7-dof (6 when fix_scale) S12, with Huber weighting, a
mid-optimization chi2 outlier rejection pass (th2 = 9.21 per edge pair,
matching the reference's removal loop), and a final inlier count.

Implementation: vectorized Gauss-Newton with central-difference Jacobians
over the 7-dim tangent increment — pair counts are O(100), so 14 residual
evaluations per iteration are microseconds; no per-edge graph machinery
needed (the TPU-native stance keeps host optimizers as flat array code).
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.utils.lie import Sim3


def _residuals(s12: Sim3, x1, x2, cam1, cam2, obs1, obs2):
    """Stacked (N, 2) + (N, 2) reprojection residuals."""
    p1 = s12.apply(x2)                 # cam-2 points mapped into cam-1
    p2 = s12.inverse().apply(x1)       # cam-1 points mapped into cam-2
    e1 = cam1.project(p1) - obs1
    e2 = cam2.project(p2) - obs2
    # points mapped behind a camera get a large finite residual (keeps GN
    # well-defined; such pairs are killed by the chi2 pass)
    bad1 = p1[:, 2] <= 1e-6
    bad2 = p2[:, 2] <= 1e-6
    e1 = np.where(bad1[:, None], 1e3, e1)
    e2 = np.where(bad2[:, None], 1e3, e2)
    return e1, e2


def optimize_sim3(
    s12_init: Sim3,
    x1: np.ndarray,
    x2: np.ndarray,
    obs1: np.ndarray,
    obs2: np.ndarray,
    cam1,
    cam2,
    inv_sigma2_1: np.ndarray,
    inv_sigma2_2: np.ndarray,
    fix_scale: bool = True,
    th2: float = 10.0,
    n_iters: int = 10,
) -> tuple[Sim3, np.ndarray, int]:
    """Returns (refined S12, inlier mask (N,), n_inliers).

    x1/x2: (N, 3) matched points in cam-1 / cam-2 frames; obs1/obs2: (N, 2)
    observed pixels; inv_sigma2_*: per-pair information weights (keypoint
    octave); th2: per-edge chi2 cut (the reference uses th2=10 with
    e2*invSigma2)."""
    n = len(x1)
    if n < 6:
        return s12_init, np.zeros(n, bool), 0
    s = s12_init.normalized()
    dof = 7 if not fix_scale else 6
    eps = 1e-6
    active = np.ones(n, bool)

    def solve_gn(s, active, iters):
        for _ in range(iters):
            e1, e2 = _residuals(s, x1, x2, cam1, cam2, obs1, obs2)
            w1 = inv_sigma2_1 * active
            w2 = inv_sigma2_2 * active
            # Huber weights (delta ~ sqrt(10))
            r1 = np.sqrt((e1 * e1).sum(1) * np.maximum(inv_sigma2_1, 1e-12))
            r2 = np.sqrt((e2 * e2).sum(1) * np.maximum(inv_sigma2_2, 1e-12))
            delta = np.sqrt(10.0)
            h1 = np.where(r1 > delta, delta / np.maximum(r1, 1e-12), 1.0)
            h2 = np.where(r2 > delta, delta / np.maximum(r2, 1e-12), 1.0)
            w1 = w1 * h1
            w2 = w2 * h2
            # central-difference Jacobian over the tangent increment
            j1 = np.zeros((n, 2, 7))
            j2 = np.zeros((n, 2, 7))
            for k in range(dof):
                d = np.zeros(7)
                d[k] = eps
                sp = (Sim3.exp(d) * s).normalized()
                sm = (Sim3.exp(-d) * s).normalized()
                e1p, e2p = _residuals(sp, x1, x2, cam1, cam2, obs1, obs2)
                e1m, e2m = _residuals(sm, x1, x2, cam1, cam2, obs1, obs2)
                j1[:, :, k] = (e1p - e1m) / (2 * eps)
                j2[:, :, k] = (e2p - e2m) / (2 * eps)
            h = (
                np.einsum("nik,n,nil->kl", j1, w1, j1)
                + np.einsum("nik,n,nil->kl", j2, w2, j2)
            )
            b = (
                np.einsum("nik,n,ni->k", j1, w1, e1)
                + np.einsum("nik,n,ni->k", j2, w2, e2)
            )
            if fix_scale:
                h[6, :] = 0.0
                h[:, 6] = 0.0
                h[6, 6] = 1.0
                b[6] = 0.0
            h = h + 1e-9 * np.eye(7)
            try:
                dx = np.linalg.solve(h, -b)
            except np.linalg.LinAlgError:
                break
            s = (Sim3.exp(dx) * s).normalized()
            if np.linalg.norm(dx) < 1e-12:
                break
        return s

    def chi2(s):
        e1, e2 = _residuals(s, x1, x2, cam1, cam2, obs1, obs2)
        c1 = (e1 * e1).sum(1) * inv_sigma2_1
        c2 = (e2 * e2).sum(1) * inv_sigma2_2
        return c1, c2

    # first pass, reject, second pass (Optimizer3.cc: optimize 5, remove
    # edges with chi2 > th2, optimize 10 more if any removed)
    s = solve_gn(s, active, 5)
    c1, c2 = chi2(s)
    inlier = (c1 < th2) & (c2 < th2)
    if (~inlier & active).any():
        active = inlier.copy()
        if active.sum() < 6:
            return s, inlier, int(inlier.sum())
        s = solve_gn(s, active, n_iters)
        c1, c2 = chi2(s)
        inlier = (c1 < th2) & (c2 < th2)
    return s, inlier, int(inlier.sum())


def optimize_sim3_pairs(kf1, kf2, matches: dict, s12_init: Sim3,
                        fix_scale: bool = True, th2: float = 10.0):
    """Convenience wrapper over keyframe structures: matches is
    {kf1_idx: loop-side MapPoint}.  Pairs always contribute the e1 edge
    (loop point projected into kf1 against the kf1 feature); the e2 edge is
    added only when the kf1 feature has its own map point AND the loop
    point is observed in kf2 (the reference's bAllPoints mode — window
    points outside kf2 get one-sided edges).
    Returns (refined S12, surviving matches, n_inliers)."""
    idx = sorted(matches.keys())
    mp2 = [matches[i] for i in idx]
    keep = [k for k, m in enumerate(mp2) if not m.bad]
    if len(keep) < 6:
        return s12_init, {}, 0
    idx = [idx[k] for k in keep]
    mp2 = [mp2[k] for k in keep]
    n = len(idx)
    x2 = np.stack([kf2.Tcw * m.position for m in mp2])
    obs1 = kf1.kps_un[idx]
    is1 = kf1.inv_level_sigma2[kf1.octave[idx]]
    x1 = np.zeros((n, 3))
    obs2 = np.zeros((n, 2))
    is2 = np.zeros(n)
    for k, (i, m) in enumerate(zip(idx, mp2)):
        mp1 = kf1.map_points[i]
        if mp1 is None or mp1.bad:
            continue
        left, right = m.observations.get(kf2, (-1, -1))
        j = left if left >= 0 else right
        if j < 0 or j >= kf2.n:
            continue
        x1[k] = kf1.Tcw * mp1.position
        obs2[k] = kf2.kps_un[j]
        is2[k] = kf2.inv_level_sigma2[kf2.octave[j]]
    s12, inlier, n_in = optimize_sim3(
        s12_init, x1, x2, obs1, obs2, kf1.camera, kf2.camera, is1, is2,
        fix_scale=fix_scale, th2=th2,
    )
    surviving = {i: m for i, m, ok in zip(idx, mp2, inlier) if ok}
    return s12, surviving, n_in
