"""MapPoint: a triangulated 3D landmark with its observations.

Role-parity with ORB_SLAM3/include/MapPoint.h (256 LoC) /
src/MapPoint.cc (634 LoC): observations registry, distinctive-descriptor
selection (min median Hamming), viewing normal + scale-invariance distance
range, visibility/found counters, replacement and culling support — written
as a compact host-side class with vectorized descriptor math.
"""

from __future__ import annotations

import math

import numpy as np


def hamming_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise Hamming distances between (N, 32) and (M, 32) -> (N, M)."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.bitwise_count(x).sum(axis=-1, dtype=np.int32)


class MapPoint:
    # Fixed attribute layout: tracking creates ~100 temporal VO points per
    # stereo frame (Tracking4.cc UpdateLastFrame role) and maps hold 10k+
    # live points; __slots__ drops the per-instance dict (~40% smaller,
    # measurably faster ctor/attribute access in the host loop).
    __slots__ = (
        "id", "_table", "_slot", "_position", "ref_kf", "map",
        "observations", "n_obs", "descriptor", "normal",
        "min_distance", "max_distance", "bad", "replaced_by",
        "n_visible", "n_found", "first_kf_id", "track_in_view",
        "track_proj", "last_frame_seen",
    )

    _next_id = 0

    def __init__(self, position: np.ndarray, ref_kf, map_):
        self.id = MapPoint._next_id
        MapPoint._next_id += 1
        # LandmarkTable mirror (set by Map.add_map_point/erase_map_point);
        # must exist before the `position` property setter runs
        self._table = None
        self._slot = -1
        self.position = np.asarray(position, np.float64).copy()
        self.ref_kf = ref_kf
        self.map = map_
        self.observations: dict = {}  # kf -> (left_idx, right_idx); -1 = none
        self.n_obs = 0
        self.descriptor = np.zeros(32, np.uint8)
        self.normal = np.zeros(3)
        self.min_distance = 0.0
        self.max_distance = 0.0
        self.bad = False
        self.replaced_by = None
        self.n_visible = 1
        self.n_found = 1
        self.first_kf_id = ref_kf.id if ref_kf is not None else -1
        self.track_in_view = False
        self.track_proj = None  # (u, v, ur, level, view_cos) while tracking
        self.last_frame_seen = -1

    # ------------------------------------------------------------------
    # LandmarkTable write-through: `position` has ~10 writers across the
    # optimizers/loop-closing, so it syncs via a property; normal/distance/
    # descriptor/n_obs are written only inside this module and sync through
    # the explicit _sync_* helpers at those sites.
    @property
    def position(self) -> np.ndarray:
        return self._position

    @position.setter
    def position(self, v):
        self._position = np.array(v, np.float64)
        t = self._table
        if t is not None:
            t.pos[self._slot] = self._position

    def _sync_geom(self):
        t = self._table
        if t is not None:
            s = self._slot
            t.normal[s] = self.normal
            t.min_d[s] = self.min_distance
            t.max_d[s] = self.max_distance

    def _sync_desc(self):
        t = self._table
        if t is not None:
            t.desc[self._slot] = self.descriptor

    def _sync_nobs(self):
        t = self._table
        if t is not None:
            t.n_obs[self._slot] = self.n_obs

    # ------------------------------------------------------------------
    def add_observation(self, kf, idx: int):
        """Record (left, right) slot indices for kf.  n_obs accounting
        follows MapPoint::AddObservation: pinhole stereo counts 2 for a
        keypoint with a right-u measurement, fisheye (camera2 present)
        counts +1 PER camera index — a dual left+right observation is two
        constraints."""
        left, right = self.observations.get(kf, (-1, -1))
        if idx >= kf.n_left:
            was_set = right >= 0
            right = idx
        else:
            was_set = left >= 0
            left = idx
        if getattr(kf, "camera2", None) is not None:
            if not was_set:
                self.n_obs += 1
        elif self.observations.get(kf, (-1, -1)) == (-1, -1):
            self.n_obs += 2 if (left >= 0 and kf.u_right[left] >= 0) else 1
        self.observations[kf] = (left, right)
        self._sync_nobs()

    def erase_observation(self, kf):
        if kf in self.observations:
            left, right = self.observations.pop(kf)
            if getattr(kf, "camera2", None) is not None:
                self.n_obs -= (left >= 0) + (right >= 0)
            elif left >= 0 and kf.u_right[left] >= 0:
                self.n_obs -= 2
            else:
                self.n_obs -= 1
            self._sync_nobs()
            if self.ref_kf is kf and self.observations:
                self.ref_kf = next(iter(self.observations))
            if self.n_obs <= 2:
                self.set_bad()

    def set_bad(self):
        self.bad = True
        obs = dict(self.observations)
        self.observations.clear()
        for kf, (left, right) in obs.items():
            if left >= 0:
                kf.map_points[left] = None
            if right >= 0:
                kf.map_points[right] = None
            kf._mp_version = getattr(kf, "_mp_version", 0) + 1
        if self.map is not None:
            self.map.erase_map_point(self)

    def replace(self, other: "MapPoint"):
        """Fuse this point into `other` (MapPoint::Replace semantics)."""
        if other.id == self.id:
            return
        obs = dict(self.observations)
        self.observations.clear()
        self.bad = True
        self.replaced_by = other
        for kf, (left, right) in obs.items():
            for idx in (left, right):
                if idx < 0:
                    continue
                if kf not in other.observations:
                    kf.map_points[idx] = other
                    other.add_observation(kf, idx)
                else:
                    kf.map_points[idx] = None
            kf._mp_version = getattr(kf, "_mp_version", 0) + 1
        other.n_found += self.n_found
        other.n_visible += self.n_visible
        other.compute_distinctive_descriptor()
        if self.map is not None:
            self.map.erase_map_point(self)

    def get_replaced(self):
        mp = self
        while mp.replaced_by is not None:
            mp = mp.replaced_by
        return mp

    # ------------------------------------------------------------------
    def compute_distinctive_descriptor(self):
        """Min-median-Hamming representative (ComputeDistinctiveDescriptors)."""
        descs = []
        for kf, (left, right) in self.observations.items():
            if kf.bad:
                continue
            if left >= 0:
                descs.append(kf.desc[left])
            if right >= 0:
                descs.append(kf.desc[right])
        if not descs:
            return
        if len(descs) == 1:
            self.descriptor = descs[0].copy()
            self._sync_desc()
            return
        d = np.asarray(descs)
        dist = hamming_rows(d, d)
        # the reference's "median" is the sorted element at (N-1)/2
        # (MapPoint::ComputeDistinctiveDescriptors), not an averaged median
        m = (len(descs) - 1) // 2
        med = np.partition(dist, m, axis=1)[:, m]
        self.descriptor = d[int(np.argmin(med))].copy()
        self._sync_desc()

    def update_normal_and_depth(self):
        if not self.observations or self.ref_kf is None:
            return
        # one normal term per camera index: left observations use the left
        # camera center, fisheye right observations the right camera center
        # (MapPoint::UpdateNormalAndDepth's leftIndex/rightIndex loop)
        rows = []
        for kf, (left, right) in self.observations.items():
            if left >= 0 or right < 0:
                rows.append(kf.camera_center())
            if right >= 0 and getattr(kf, "camera2", None) is not None:
                rows.append(kf.right_camera_center())
        centers = np.stack(rows)
        v = self.position[None, :] - centers
        nv = np.sqrt((v * v).sum(axis=1))
        good = nv > 1e-9
        if not good.any():
            return
        self.normal = (v[good] / nv[good][:, None]).mean(axis=0)
        nn = math.sqrt(float(self.normal @ self.normal))
        if nn > 1e-9:
            self.normal /= nn
        left, right = self.observations.get(self.ref_kf, (-1, -1))
        idx = left if left >= 0 else right
        if idx < 0:
            idx = 0
        d = self.position - self.ref_kf.camera_center()
        dist = math.sqrt(float(d @ d))
        level = int(self.ref_kf.octave[idx]) if idx < self.ref_kf.n else 0
        factor = self.ref_kf.scale_factors[level]
        n_levels = self.ref_kf.n_levels
        self.max_distance = dist * factor
        self.min_distance = self.max_distance / self.ref_kf.scale_factors[n_levels - 1]
        self._sync_geom()

    def predict_scale(self, dist: float, frame) -> int:
        """Octave the point would be detected at (MapPoint::PredictScale)."""
        ratio = self.max_distance / max(dist, 1e-9)
        level = int(np.ceil(np.log(ratio) / frame.log_scale_factor))
        return int(np.clip(level, 0, frame.n_levels - 1))

    def increase_visible(self, n=1):
        self.n_visible += n

    def increase_found(self, n=1):
        self.n_found += n

    @property
    def found_ratio(self) -> float:
        return self.n_found / max(self.n_visible, 1)

    @classmethod
    def new_temporal_batch(cls, positions: np.ndarray, descs: np.ndarray):
        """Bulk-construct unattached temporal VO points (UpdateLastFrame
        creates ~100 per stereo frame; this skips the per-instance property
        machinery and zero-buffer allocations of __init__)."""
        n = len(positions)
        base = cls._next_id
        cls._next_id = base + n
        # dedicated buffers so row views are independent of caller arrays;
        # in-place writes touch only their own row, rebinds just rebind
        positions = np.array(positions, np.float64, copy=True)
        descs = np.array(descs, np.uint8, copy=True)
        zeros3 = np.zeros(3)
        zeros3.setflags(write=False)  # shared placeholder; writers rebind
        out = []
        for k in range(n):
            mp = cls.__new__(cls)
            mp.id = base + k
            mp._table = None
            mp._slot = -1
            mp._position = positions[k]
            mp.ref_kf = None
            mp.map = None
            mp.observations = {}
            mp.n_obs = 0
            mp.descriptor = descs[k]
            mp.normal = zeros3
            mp.min_distance = 0.0
            mp.max_distance = 0.0
            mp.bad = False
            mp.replaced_by = None
            mp.n_visible = 1
            mp.n_found = 1
            mp.first_kf_id = -1
            mp.track_in_view = False
            mp.track_proj = None
            mp.last_frame_seen = -1
            out.append(mp)
        return out


def refresh_points(mps, descriptors: bool = True) -> None:
    """Batched compute_distinctive_descriptor + update_normal_and_depth.

    Same results as the per-point methods, vectorized across a whole batch
    (the per-KF maintenance loops touch ~2k points per keyframe insertion;
    one fused pass replaces ~2k x ~30 small NumPy calls).  KeyFrame camera
    centers are interned once per distinct KF.  `descriptors=False` runs
    only the normal/depth pass (local BA's post-update).
    """
    from orbslam3_tpu_torch.native import hostops

    arr = np.empty(len(mps), object)
    arr[:] = list(mps)
    counts = hostops.obs_counts(arr)
    keep = counts > 0
    if descriptors:
        # The NumPy-fallback descriptor pass pads every group to the
        # batch-wide max observation count; a single long-lived landmark
        # with ~100 obs would inflate its (G, nmax, nmax, 32) XOR tensor to
        # hundreds of MB.  Heavily-observed points take the per-point path.
        heavy = keep & (counts > 24)
        if heavy.any():
            for mp in arr[heavy]:
                mp.compute_distinctive_descriptor()
                mp.update_normal_and_depth()
            keep &= counts <= 24
    mps = list(arr[keep])
    if not mps:
        return
    g_count = len(mps)
    # Flatten the observation graphs in one C pass (row order = point
    # order then observation insertion order, which the argmin tie-break
    # below depends on); camera centers intern once per distinct KF.
    pos, needn, grp, kfi, left, right, kfs = hostops.collect_obs(mps)
    if descriptors and len(grp):
        kf_bad = np.fromiter((kf.bad for kf in kfs), bool, len(kfs))
        # interleave left/right so within-group candidate order matches the
        # per-point method exactly
        cand_row = np.stack([left, right], axis=1).ravel()
        cand_kfi = np.repeat(kfi, 2)
        cand_grp = np.repeat(grp, 2)
        ok = (cand_row >= 0) & ~kf_bad[cand_kfi]
        descs_kf = cand_kfi[ok]
        descs_row = cand_row[ok]
        dgrp = cand_grp[ok]
        kf_descs = [kf.desc for kf in kfs]
    else:
        descs_kf = descs_row = dgrp = np.empty(0, np.int64)
        kf_descs = []
    omask = needn[grp] if len(grp) else np.zeros(0, bool)
    # one normal term per camera index (fisheye dual observations get a
    # second term anchored at the right camera center — the reference's
    # leftIndex/rightIndex loop in MapPoint::UpdateNormalAndDepth)
    fish_kf = (
        np.fromiter(
            (getattr(kf, "camera2", None) is not None for kf in kfs),
            bool, len(kfs),
        )
        if len(kfs)
        else np.zeros(0, bool)
    )
    lmask = omask & ((left >= 0) | (right < 0))
    rmask = omask & (right >= 0) & fish_kf[kfi] if len(grp) else omask
    ogrp = np.concatenate([grp[lmask], grp[rmask]])
    ocen = np.concatenate([kfi[lmask], kfi[rmask]])
    o_right = np.r_[np.zeros(int(lmask.sum()), bool), np.ones(int(rmask.sum()), bool)]
    # centers only for KFs actually referenced by a need_norm observation
    # (duck-typed stand-ins without camera_center stay untouched, as in the
    # per-point method which early-returns when ref_kf is None)
    centers = np.zeros((len(kfs), 3))
    centers_r = np.zeros((len(kfs), 3))
    for ui in np.unique(ocen) if len(ocen) else []:
        centers[ui] = kfs[ui].camera_center()
        if fish_kf[ui]:
            centers_r[ui] = kfs[ui].right_camera_center()

    # --- distinctive descriptors (min median Hamming per group) ----------
    if len(descs_kf):
        from orbslam3_tpu_torch import native

        ka = np.asarray(descs_kf)
        ra = np.asarray(descs_row)
        d_all = np.empty((len(ka), 32), np.uint8)
        korder = np.argsort(ka, kind="stable")
        ka_s = ka[korder]
        kbounds = np.r_[0, np.nonzero(np.diff(ka_s))[0] + 1, len(ka_s)]
        for b0, b1 in zip(kbounds[:-1], kbounds[1:]):
            sel = korder[b0:b1]
            d_all[sel] = kf_descs[int(ka_s[b0])][ra[sel]]
        dg = np.asarray(dgrp)
        counts = np.bincount(dg, minlength=g_count)
        off = np.zeros(g_count + 1, np.int64)
        np.cumsum(counts, out=off[1:])  # observations are group-ordered
        rows = native.distinctive_select(d_all, off)
        if rows is not None:
            hit = rows >= 0
            choice = d_all[np.maximum(rows, 0)]
        else:  # NumPy fallback: padded-block median over the batch
            nmax = int(counts.max())
            rank = np.arange(len(dg)) - off[dg]
            block = np.zeros((g_count, nmax, 32), np.uint8)
            block[dg, rank] = d_all
            dist = np.bitwise_count(
                block[:, :, None, :] ^ block[:, None, :, :]
            ).sum(-1, dtype=np.int32)  # (G, nmax, nmax)
            col_ok = np.arange(nmax)[None, :] < counts[:, None]
            dist = np.where(col_ok[:, None, :], dist, 1 << 20)
            dist.sort(axis=2)
            m = np.maximum(counts - 1, 0) // 2  # reference's sorted[(N-1)/2]
            med = np.take_along_axis(dist, m[:, None, None], axis=2)[:, :, 0]
            med = np.where(col_ok, med, 1 << 20)
            best = med.argmin(axis=1)
            choice = block[np.arange(g_count), best]
            hit = counts > 0
        hitg = np.nonzero(hit)[0]
        chosen = choice[hitg].copy()  # one contiguous block; rows are views
        for j, g in enumerate(hitg):
            mp = mps[g]
            mp.descriptor = chosen[j]
            sync = getattr(mp, "_sync_desc", None)  # duck-typed stand-ins
            if sync is not None:
                sync()

    # --- normals + scale-invariance depth range --------------------------
    if len(ogrp) == 0:
        return
    og = np.asarray(ogrp)
    oc = np.asarray(ocen)
    cen = np.where(o_right[:, None], centers_r[oc], centers[oc])
    v = pos[og] - cen
    nv = np.sqrt((v * v).sum(axis=1))
    good = nv > 1e-9
    vg, ogg = v[good] / nv[good][:, None], og[good]
    cnt = np.bincount(ogg, minlength=g_count)
    sums = np.stack(
        [np.bincount(ogg, weights=vg[:, a], minlength=g_count) for a in range(3)],
        axis=1,
    )
    normal = sums / np.maximum(cnt, 1)[:, None]
    nn = np.sqrt((normal * normal).sum(axis=1))
    normal = np.where(nn[:, None] > 1e-9, normal / np.maximum(nn, 1e-30)[:, None], normal)
    # --- reference-KF depth range, batched -------------------------------
    # The per-point loop's cost was ~10 small NumPy calls per landmark
    # (subtract/dot/sqrt against ref centers + per-KF octave lookups);
    # gather the ref observation row per group from the flattened arrays
    # and evaluate the whole batch at once, grouping the octave gathers by
    # distinct reference KF.
    kf_of = {id(kf): i for i, kf in enumerate(kfs)}
    ref_ki = np.full(g_count, -1, np.int64)
    todo = []
    for g, mp in enumerate(mps):
        ref = mp.ref_kf
        if ref is None or cnt[g] == 0:
            continue
        ki = kf_of.get(id(ref), -1)
        if ki < 0:  # ref not among the observed KFs (rare): per-point path
            mp.update_normal_and_depth()
            continue
        ref_ki[g] = ki
        todo.append(g)
    if not todo:
        return
    todo = np.asarray(todo, np.int64)
    # the (group, ref-KF) observation row, if present (at most one per pair)
    is_ref = kfi == ref_ki[grp]
    ref_row = np.full(g_count, -1, np.int64)
    ref_row[grp[is_ref]] = np.nonzero(is_ref)[0]
    rr = ref_row[todo]
    has = rr >= 0
    idxs = np.zeros(len(todo), np.int64)
    li, ri = left[rr[has]], right[rr[has]]
    # per-point semantics: left if >=0 else right; if both -1 -> 0
    idxs[has] = np.maximum(np.where(li >= 0, li, ri), 0)
    rki = ref_ki[todo]
    ref_centers = np.zeros((len(kfs), 3))
    for ui in np.unique(rki):
        ref_centers[ui] = kfs[ui].camera_center()
    d = pos[todo] - ref_centers[rki]
    dist_r = np.sqrt((d * d).sum(axis=1))
    maxd = np.empty(len(todo))
    mind = np.empty(len(todo))
    order = np.argsort(rki, kind="stable")
    bounds = np.r_[0, np.nonzero(np.diff(rki[order]))[0] + 1, len(order)]
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        sel = order[b0:b1]
        ref = kfs[int(rki[sel[0]])]
        ii = idxs[sel]
        sf = np.asarray(ref.scale_factors)
        if ref.n > 0:
            lv = np.where(
                ii < ref.n, np.asarray(ref.octave)[np.minimum(ii, ref.n - 1)], 0
            )
        else:
            lv = np.zeros(len(ii), np.int64)
        maxd[sel] = dist_r[sel] * sf[lv]
        mind[sel] = maxd[sel] / sf[ref.n_levels - 1]
    norm_rows = normal[todo].copy()  # contiguous; rows become mp.normal views
    for j, g in enumerate(todo):
        mp = mps[g]
        mp.normal = norm_rows[j]
        mp.max_distance = float(maxd[j])
        mp.min_distance = float(mind[j])
        sync = getattr(mp, "_sync_geom", None)  # duck-typed stand-ins
        if sync is not None:
            sync()
