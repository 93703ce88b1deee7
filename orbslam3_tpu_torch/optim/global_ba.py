"""Global bundle adjustment over a whole map.

GlobalBundleAdjustemnt role (ORB_SLAM3/src/Optimizer1.cc:48,56) on the
vectorized Schur LM, plus the inertial variant (FullInertialBA,
Optimizer1.cc:388) which alternates the visual solve with the 15-dof
temporal-chain adjustment of local_inertial_ba (same block-coordinate split,
map-wide window)."""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.optim.bundle_adjustment import BAProblem, bundle_adjust


def build_global_ba(m):
    """Snapshot the map into a BAProblem WITHOUT solving.

    Returns None or (kfs, mps, pr).  The transient GBA thread calls this
    under the map lock + LocalMapping pause (the observation graph is
    mutated by the mapper outside any lock), then solves lock-free."""
    kfs = [k for k in m.get_all_keyframes() if not k.bad]
    mps = [mp for mp in m.get_all_map_points() if not mp.bad]
    if len(kfs) < 2 or len(mps) < 20:
        return None
    kf_slot = {k: i for i, k in enumerate(kfs)}
    # C-speed flattening of the observation graphs (same edge order as the
    # per-observation Python loop this replaces: point order, then
    # observation insertion order), then vectorized per-KF feature gathers.
    from orbslam3_tpu_torch.native import hostops

    counts = hostops.obs_counts(mps)
    old_idx = np.nonzero(counts > 0)[0]
    kept_mps = [mps[i] for i in old_idx]
    if not kept_mps:
        return None
    _, _, grp, kfi, left_a, right_a, obs_kfs = hostops.collect_obs(kept_mps)
    slot_by_kf = np.fromiter(
        (kf_slot[k] if (k in kf_slot and not k.bad) else -1 for k in obs_kfs),
        np.int64,
        count=len(obs_kfs),
    )
    # one edge per SET slot — fisheye dual observations contribute a left
    # edge AND a body-frame right edge (EdgeSE3ProjectXYZToBody; same
    # layout as local_ba.py)
    has_l, has_r = left_a >= 0, right_a >= 0
    grp = np.concatenate([grp[has_l], grp[has_r]])
    kfi = np.concatenate([kfi[has_l], kfi[has_r]])
    i_e = np.concatenate([left_a[has_l], right_a[has_r]])
    keep = slot_by_kf[kfi] >= 0 if len(kfi) else np.zeros(0, bool)
    grp, kfi, i_e = grp[keep], kfi[keep], i_e[keep]
    cam_idx = slot_by_kf[kfi]
    pt_idx = old_idx[grp]
    n_e = len(cam_idx)
    if n_e < 50:
        return None
    uv = np.empty((n_e, 2))
    ur = np.empty(n_e)
    is2 = np.empty(n_e)
    is_right = np.zeros(n_e, bool)
    # group edges by KF with one argsort (O(E log E), not O(E x KFs))
    order = np.argsort(kfi, kind="stable")
    kfi_s = kfi[order]
    bounds = np.r_[0, np.nonzero(np.diff(kfi_s))[0] + 1, n_e]
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        sel = order[b0:b1]
        k = obs_kfs[int(kfi_s[b0])]
        ii = i_e[sel]
        uv[sel] = k.kps_un[ii]
        ur[sel] = k.u_right[ii]
        is2[sel] = k.inv_level_sigma2[k.octave[ii]]
        is_right[sel] = ii >= getattr(k, "n_left", len(k.kps_un))
    fixed = np.zeros(len(kfs), bool)
    fixed[0] = True
    pr = BAProblem(
        poses=[k.Tcw.copy() for k in kfs],
        points=np.stack([mp.position for mp in mps]),
        cam_idx=cam_idx,
        pt_idx=pt_idx,
        obs_uv=uv,
        obs_ur=ur,
        inv_sigma2=is2,
        fixed_cams=fixed,
        camera=kfs[0].camera,
        mbf=kfs[0].mbf,
        is_right=is_right if is_right.any() else None,
        camera2=getattr(kfs[0], "camera2", None),
        Trl=getattr(kfs[0], "Trl", None),
    )
    return kfs, mps, pr


def solve_global_ba(m, n_iters: int = 10):
    """build_global_ba + solve; returns None or a solution tuple for
    `apply_global_ba` (sequential convenience; the GBA thread splits the
    phases so only the snapshot holds the locks)."""
    built = build_global_ba(m)
    if built is None:
        return None
    kfs, mps, pr = built
    poses, points, _ = bundle_adjust(pr, n_iters=n_iters)
    return kfs, poses, mps, points


def apply_global_ba(m, solution) -> int:
    """Write a solve_global_ba solution back, reconciling keyframes and map
    points created WHILE the solve ran (the reference's mTcwGBA spanning-
    tree propagation + reference-KF point correction,
    ORB_SLAM3/src/LoopClosing3.cc:520+).  Caller holds the map lock
    (+ LocalMapping pause in threaded mode)."""
    kfs, poses, mps, points = solution
    in_snap = {k.id for k in kfs}
    corr: dict = {}  # kf -> (Tcw_old, Tcw_gba)
    # fixed keyframes keep their SOLVE-TIME pose (bundle_adjust returns the
    # snapshot pose unchanged for fixed cams) — NOT the current pose: if
    # local BA moved the anchor during an off-thread solve, writing the new
    # pose would offset the anchor from the solved, old-anchor-consistent map
    for k, p in zip(kfs, poses):
        if not k.bad:
            corr[k] = (k.Tcw.copy(), p)
    # keyframes added during the solve: Tcw_gba = Tcw*Twc_parent*Tcw_gba_par
    new_kfs = [k for k in m.get_all_keyframes()
               if not k.bad and k.id not in in_snap]
    new_kfs.sort(key=lambda k: k.id)  # parents precede children
    for k in new_kfs:
        par = k.parent
        if par is None or par not in corr:
            continue
        t_old_par, t_gba_par = corr[par]
        corr[k] = (k.Tcw.copy(), (k.Tcw * t_old_par.inverse()) * t_gba_par)
    snap_pts = {mp.id for mp in mps}
    for k, (_, t_gba) in corr.items():
        k.set_pose(t_gba)
    refreshed = []
    for mp, pos in zip(mps, points):
        if not mp.bad:
            mp.position = pos
            refreshed.append(mp)
    # points created during the solve move with their reference keyframe
    for mp in m.get_all_map_points():
        if mp.bad or mp.id in snap_pts:
            continue
        ref = mp.ref_kf
        if ref is None or ref not in corr:
            continue
        t_old, t_gba = corr[ref]
        mp.position = t_gba.inverse() * (t_old * mp.position)
        refreshed.append(mp)
    from orbslam3_tpu_torch.slam.map_point import refresh_points

    refresh_points(refreshed, descriptors=False)
    m.info_changed()
    return len(kfs)


def global_bundle_adjustment(m, n_iters: int = 10) -> int:
    """Full-map visual BA, first KF fixed.  Returns #poses optimized."""
    sol = solve_global_ba(m, n_iters=n_iters)
    if sol is None:
        return 0
    return apply_global_ba(m, sol)


def full_inertial_ba(m, calib, n_alternations: int = 2, opt_scale: bool = False,
                     ba_prior_sigma: float | None = None):
    """FullInertialBA role: refine every temporal-chain state (pose,
    velocity, bias) and every landmark of a VI-initialized map.

    Same split as local_inertial_ba: landmarks move in the visual Schur
    pass, 15-dof states move in the dense chain pass — here the chain is
    the map's entire temporal backbone (anchor: the oldest chain KF's pose).

    With `opt_scale` (mono-inertial) the chain pass additionally solves a
    global landmark scale jointly with the poses (see
    optimize_inertial_window) and the whole map is rescaled accordingly.
    Returns the chain length, or (chain length, cumulative scale,
    scale center) when opt_scale is set.
    """
    from orbslam3_tpu_torch.imu.preintegration import Bias
    from orbslam3_tpu_torch.optim.local_inertial_ba import (
        NavState,
        optimize_inertial_window,
    )
    from orbslam3_tpu_torch.utils.lie import SE3

    # longest temporal chain ending at the newest keyframe
    kfs = [k for k in m.get_all_keyframes() if not k.bad]
    if not kfs:
        return 0
    tail = max(kfs, key=lambda k: k.id)
    chain = [tail]
    while (
        chain[-1].prev_kf is not None
        and not chain[-1].prev_kf.bad
        and chain[-1].imu_preint is not None
    ):
        chain.append(chain[-1].prev_kf)
    chain.reverse()
    if len(chain) < 3:
        n = global_bundle_adjustment(m)
        return (n, 1.0, np.zeros(3)) if opt_scale else n
    Tbc = calib.Tbc
    Tcb = Tbc.inverse()
    s_total = 1.0
    s_center_out = np.zeros(3)

    for _ in range(n_alternations):
        global_bundle_adjustment(m)
        states = []
        for k in chain:
            Twb = (k.Twc * Tcb).normalized()
            states.append(
                NavState(
                    Twb.R,
                    Twb.t,
                    k.velocity if k.velocity is not None else np.zeros(3),
                    k.imu_bias.bg.copy(),
                    k.imu_bias.ba.copy(),
                )
            )
        preints = [chain[i + 1].imu_preint for i in range(len(chain) - 1)]
        if any(p is None for p in preints):
            return (0, s_total, s_center_out) if opt_scale else 0
        kf_idx, pw, uv, ur, is2, isr = [], [], [], [], [], []
        for i, k in enumerate(chain):
            for j, mp in k.get_map_point_indices():
                kf_idx.append(i)
                pw.append(mp.position)
                uv.append(k.kps_un[j])
                ur.append(k.u_right[j])
                is2.append(k.inv_level_sigma2[k.octave[j]])
                isr.append(j >= getattr(k, "n_left", len(k.kps_un)))
        obs = dict(
            kf_idx=np.asarray(kf_idx),
            pw=np.asarray(pw, np.float64),
            uv=np.asarray(uv, np.float64),
            ur=np.asarray(ur, np.float64),
            inv_sigma2=np.asarray(is2, np.float64),
            camera=tail.camera,
            mbf=tail.mbf,
            is_right=(
                np.asarray(isr, bool)
                if getattr(tail, "camera2", None) is not None
                else None
            ),
            camera2=getattr(tail, "camera2", None),
            Trl=getattr(tail, "Trl", None),
        )
        fixed = np.zeros(len(chain), bool)
        fixed[0] = True
        if opt_scale:
            states, _, s_corr, s_center = optimize_inertial_window(
                states, preints, obs, Tcb, fixed, opt_scale=True,
                ba_prior_sigma=ba_prior_sigma,
            )
        else:
            states, _ = optimize_inertial_window(
                states, preints, obs, Tcb, fixed, ba_prior_sigma=ba_prior_sigma
            )
            s_corr, s_center = 1.0, np.zeros(3)
        for k, s in zip(chain, states):
            Twb = SE3(s.R, s.p).normalized()
            k.set_pose((Twb * Tbc).inverse())
            k.velocity = s.v.copy()
            k.imu_bias = Bias(s.ba.copy(), s.bg.copy())
            if k.imu_preint is not None:
                k.imu_preint.set_new_bias(k.imu_bias)
        if opt_scale and abs(s_corr - 1.0) > 1e-9:
            # physically apply the landmark scale the chain pass solved for
            # (scaled about the anchor, keeping it fixed)
            chain_set = set(chain)
            for mp in m.get_all_map_points():
                mp.position = s_center + s_corr * (mp.position - s_center)
            for k in m.get_all_keyframes():
                if k in chain_set or k.bad:
                    continue
                twc = k.Twc
                k.set_pose(
                    SE3(twc.R, s_center + s_corr * (twc.t - s_center)).inverse()
                )
                if k.velocity is not None:
                    k.velocity = k.velocity * s_corr
            s_total *= s_corr
            s_center_out = s_center
    m.info_changed()
    return (len(chain), s_total, s_center_out) if opt_scale else len(chain)
