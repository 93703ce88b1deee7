"""Local bundle adjustment over the covisibility window.

Semantics of Optimizer::LocalBundleAdjustment (ORB_SLAM3/src/
Optimizer2.cc:350): local KFs = current + its covisibles; local points =
everything they observe; fixed KFs = all other observers of those points;
two-stage optimize with Huber, then erase chi2-outlier observations from
the map.  Built on the vectorized Schur LM in bundle_adjustment.py.
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.optim.bundle_adjustment import (
    BAProblem,
    CHI2_MONO,
    CHI2_STEREO,
    bundle_adjust,
)


import contextlib


def local_bundle_adjustment(
    kf, map_, abort_flag=None, max_fixed: int = 200, map_lock=None
):
    """abort_flag: optional AbortFlag the tracker sets on keyframe
    insertion (LocalMapping::mbAbortBA) — checked before starting, between
    LM iterations (bundle_adjust polls it, native loop included), and
    between the two stages; an aborted stage still writes back its partial
    result, exactly like the reference's force-stopped g2o optimize
    (ORB_SLAM3/src/LocalMapping.cc:284-296, Optimizer2.cc:350).

    map_lock: optional map-update lock (Map.update_lock).  The reference
    holds mMutexMapUpdate only while RECOVERING optimized data — the g2o
    solve runs unlocked so Tracking proceeds concurrently
    (src/Optimizer2.cc:350 region: "Get Map Mutex" comes after optimize).
    Mirrored here: graph collection and write-back run under the lock
    (the tracker structurally mutates observations when it creates a
    keyframe), the LM solve between them runs unlocked."""
    lock = map_lock if map_lock is not None else contextlib.nullcontext()
    if abort_flag is not None and abort_flag:
        return 0
    with lock:
        pr, meta = _collect_local_ba(kf, max_fixed)
    if pr is None:
        return 0
    all_kfs, local_kfs, local_mps, kf_slot, obs_kfs, kfi, pt_idx = meta

    poses, points, chi2 = bundle_adjust(pr, n_iters=5, abort_flag=abort_flag)
    # second stage without outliers — skipped when interrupted (bDoMore)
    stereo = pr.obs_ur >= 0
    th = np.where(stereo, CHI2_STEREO, CHI2_MONO)
    if abort_flag is None or not abort_flag:
        active = chi2 <= th
        pr2 = BAProblem(**{**pr.__dict__, "poses": poses, "points": points})
        poses, points, chi2 = bundle_adjust(
            pr2, n_iters=10, active=active, abort_flag=abort_flag
        )

    with lock:
        _write_back_local_ba(
            map_, pr, meta, poses, points, chi2, th
        )
    return len(local_kfs)


def _collect_local_ba(kf, max_fixed: int):
    """Build the local-BA problem from the covisibility window (locked
    phase — reads observation dicts the tracker can grow)."""
    local_kfs = [kf] + [k for k in kf.get_best_covisibility_keyframes(1000) if not k.bad]
    local_set = set(local_kfs)
    local_mps = []
    mp_seen = set()
    for k in local_kfs:
        for i, mp in k.get_map_point_indices():
            if mp.id not in mp_seen:
                mp_seen.add(mp.id)
                local_mps.append(mp)
    fixed = []
    fixed_set = set()
    for mp in local_mps:
        for k in mp.observations:
            if k not in local_set and k not in fixed_set and not k.bad:
                fixed_set.add(k)
                fixed.append(k)
                if len(fixed) >= max_fixed:
                    break
        if len(fixed) >= max_fixed:
            break
    # gauge: at least one fixed pose (or the oldest local)
    if not fixed and len(local_kfs) > 2:
        fixed = [min(local_kfs, key=lambda k: k.id)]
        fixed_set = set(fixed)
        local_kfs = [k for k in local_kfs if k not in fixed_set]
        local_set = set(local_kfs)

    all_kfs = local_kfs + fixed
    kf_slot = {k: i for i, k in enumerate(all_kfs)}
    mp_slot = {mp.id: j for j, mp in enumerate(local_mps)}

    # Flatten the observation graphs C-speed (hostops.collect_obs preserves
    # point order then observation insertion order, so edge order — and with
    # it every downstream tie-break — matches the per-edge Python loop this
    # replaces exactly), then vectorize the per-KF feature gathers.
    from orbslam3_tpu_torch.native import hostops

    # collect_obs requires non-bad, observed points; a point can turn bad
    # between collection and here (mapper-side culling), so prefilter and
    # remap edge groups back to local_mps indices.
    counts = hostops.obs_counts(local_mps)
    old_idx = np.nonzero(counts > 0)[0]
    kept_mps = [local_mps[i] for i in old_idx]
    if not kept_mps:
        return None, None
    _, _, grp, kfi, left_a, right_a, obs_kfs = hostops.collect_obs(kept_mps)
    grp = old_idx[grp]
    slot_by_kf = np.fromiter(
        (kf_slot[k] if (k in kf_slot and not k.bad) else -1 for k in obs_kfs),
        np.int64,
        count=len(obs_kfs),
    )
    # One edge per SET slot: a fisheye dual observation (left AND right
    # index) contributes TWO edges — the left one through the KF's camera,
    # the right one through Trl + camera2 (EdgeSE3ProjectXYZToBody; the
    # reference's LocalBundleAdjustment builds vpEdgesBody alongside
    # vpEdgesMono, src/Optimizer2.cc:485,610).  Pinhole KFs have right == -1
    # everywhere, so this reduces to the single-edge layout there.
    has_l, has_r = left_a >= 0, right_a >= 0
    grp = np.concatenate([grp[has_l], grp[has_r]])
    kfi = np.concatenate([kfi[has_l], kfi[has_r]])
    i_e = np.concatenate([left_a[has_l], right_a[has_r]])
    keep = slot_by_kf[kfi] >= 0 if len(kfi) else np.zeros(0, bool)
    grp, kfi, i_e = grp[keep], kfi[keep], i_e[keep]
    cam_idx = slot_by_kf[kfi]
    pt_idx = grp
    n_e = len(cam_idx)
    if n_e < 10 or len(local_kfs) == 0:
        return None, None
    uv = np.empty((n_e, 2))
    ur = np.empty(n_e)
    inv_s2 = np.empty(n_e)
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
        inv_s2[sel] = k.inv_level_sigma2[k.octave[ii]]
        is_right[sel] = ii >= getattr(k, "n_left", len(k.kps_un))
    fixed_mask = np.zeros(len(all_kfs), bool)
    fixed_mask[len(local_kfs):] = True
    if not fixed_mask.any():
        fixed_mask[0] = True  # gauge freedom

    pr = BAProblem(
        poses=[k.Tcw for k in all_kfs],
        points=np.stack([mp.position for mp in local_mps]),
        cam_idx=cam_idx,
        pt_idx=pt_idx,
        obs_uv=uv,
        obs_ur=ur,
        inv_sigma2=inv_s2,
        fixed_cams=fixed_mask,
        camera=kf.camera,
        mbf=kf.mbf,
        is_right=is_right if is_right.any() else None,
        camera2=kf.camera2,
        Trl=kf.Trl,
    )
    return pr, (all_kfs, local_kfs, local_mps, kf_slot, obs_kfs, kfi, pt_idx)


def _write_back_local_ba(map_, pr, meta, poses, points, chi2, th):
    """Recover optimized data into the map (locked phase — the
    reference's post-optimize section under mMutexMapUpdate).  A KF/point
    can have turned bad during the unlocked solve (mapper culling cannot
    — it runs on this same thread — but loop-closing merge can in
    principle); write-back tolerates it the way the reference re-checks
    isBad() on recover."""
    all_kfs, local_kfs, local_mps, kf_slot, obs_kfs, kfi, pt_idx = meta
    for k, p in zip(all_kfs, poses):
        if not pr.fixed_cams[kf_slot[k]] and not k.bad:
            k.set_pose(p)
    for mp, pos in zip(local_mps, points):
        if not mp.bad:
            mp.position = pos
    from orbslam3_tpu_torch.slam.map_point import refresh_points

    refresh_points([mp for mp in local_mps if not mp.bad], descriptors=False)
    # erase outlier observations
    bad = chi2 > th
    n_erased = 0
    for o in np.nonzero(bad)[0]:
        k, mp = obs_kfs[kfi[o]], local_mps[pt_idx[o]]
        if pr.fixed_cams[kf_slot[k]]:
            continue
        if k not in mp.observations:
            continue  # both edges of a dual observation were outliers
        # erase the WHOLE observation — both slots for a fisheye dual
        # observation (the reference's EraseMapPointMatch + EraseObservation
        # pair on either a mono or a body outlier edge)
        k.erase_map_point_match(mp)
        mp.erase_observation(k)
        n_erased += 1
    map_.info_changed()
