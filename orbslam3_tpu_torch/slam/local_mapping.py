"""Local mapping: keyframe processing, triangulation, fusion, local BA,
culling.

Role-parity with ORB_SLAM3/src/LocalMapping.cc (1,522 LoC) —
ProcessNewKeyFrame (:298), MapPointCulling (:346), CreateNewMapPoints
(:388), SearchInNeighbors (:714), KeyFrameCulling (:902) — as a class that
can run either synchronously (deterministic; called per inserted KF) or on
a worker thread (System starts it with spin()).
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from orbslam3_tpu_torch.optim.bundle_adjustment import AbortFlag
from orbslam3_tpu_torch.optim.local_ba import local_bundle_adjustment
from orbslam3_tpu_torch.optim.triangulate import (
    triangulate_linear,  # noqa: F401 — re-exported for tests/tools
    triangulate_linear_rows,
)
from orbslam3_tpu_torch.slam import matchers
from orbslam3_tpu_torch.slam.map_point import MapPoint, refresh_points


def _per_index_rig(kf, idxs):
    """Per-observation pose/camera selection for a (possibly fisheye) KF:
    indices >= n_left live in the right camera, with pose Trl*Tcw
    (the reference's per-match sophTcw/Ow/pCamera selection,
    ORB_SLAM3/src/LocalMapping.cc:500-560).

    Returns (R (N,3,3), t (N,3), centers (N,3), unproject fn, project fn,
    is_right (N,) bool)."""
    n = len(idxs)
    T = kf.Tcw
    if getattr(kf, "camera2", None) is None:
        R = np.broadcast_to(T.R, (n, 3, 3))
        t = np.broadcast_to(T.t, (n, 3))
        ow = np.broadcast_to(kf.Twc.t, (n, 3))
        return R, t, ow, kf.camera.unproject, kf.camera.project, np.zeros(n, bool)
    right = np.asarray(idxs) >= kf.n_left
    Tr = kf.get_right_pose()
    R = np.where(right[:, None, None], Tr.R, T.R)
    t = np.where(right[:, None], Tr.t, T.t)
    ow = np.where(right[:, None], Tr.inverse().t, kf.Twc.t)

    def unproject(kps, right=right):
        out = np.empty((len(kps), 3))
        if (~right).any():
            out[~right] = kf.camera.unproject(kps[~right])
        if right.any():
            out[right] = kf.camera2.unproject(kps[right])
        return out

    def project(pc, right=right):
        out = np.empty((len(pc), 2))
        if (~right).any():
            out[~right] = kf.camera.project(pc[~right])
        if right.any():
            out[right] = kf.camera2.project(pc[right])
        return out

    return R, t, ow, unproject, project, right


def triangulation_gates(kf, kf2, pairs):
    """Vectorized candidate-pair ladder of CreateNewMapPoints.

    Semantics-identical to the reference's per-pair ladder
    (ORB_SLAM3/src/LocalMapping.cc:461-584): parallax choice,
    DLT-vs-stereo source select, cheirality, per-view reprojection chi2
    (stereo obs: combined <= 7.8 incl. right-view error; mono: <= 5.991),
    scale consistency — evaluated as (N,) array ops instead of a Python
    loop.  Fisheye KFs select per-index pose/camera (left or right rig
    camera), and — like the reference — treat every fisheye observation as
    mono (bStereo is gated on !mpCamera2, so no stereo-depth fallback and
    no right-u term).  Returns (ok mask, world points (N, 3), i1s, i2s).
    """
    i1s = np.fromiter((p[0] for p in pairs), np.int64, len(pairs))
    i2s = np.fromiter((p[1] for p in pairs), np.int64, len(pairs))
    R1, t1, ow1, unproj1, proj1, _ = _per_index_rig(kf, i1s)
    R2, t2, ow2, unproj2, proj2, _ = _per_index_rig(kf2, i2s)
    import os

    _dual = os.environ.get("ORBSLAM3_TPU_DUAL_TRI", "1") == "1"
    fish1 = getattr(kf, "camera2", None) is not None and _dual
    fish2 = getattr(kf2, "camera2", None) is not None and _dual
    b1 = unproj1(kf.kps_un[i1s])  # (N, 3) in the per-index camera frame
    b2 = unproj2(kf2.kps_un[i2s])
    r1 = np.einsum("ni,nij->nj", b1, R1)  # rows = R^T b (world direction)
    r2 = np.einsum("ni,nij->nj", b2, R2)
    cos_par = np.einsum("ij,ij->i", r1, r2) / (
        np.linalg.norm(r1, axis=1) * np.linalg.norm(r2, axis=1)
    )
    # pinhole-stereo depth shortcut (bStereo gates on !mpCamera2)
    z1d = np.where(fish1, -1.0, kf.depth[i1s])
    z2d = np.where(fish2, -1.0, kf2.depth[i2s])
    cos_st1 = np.where(z1d > 0, np.cos(2 * np.arctan2(kf.mb / 2, z1d)), 2.0)
    cos_st2 = np.where(z2d > 0, np.cos(2 * np.arctan2(kf2.mb / 2, z2d)), 2.0)
    cos_st = np.minimum(cos_st1, cos_st2)
    tri = (0 < cos_par) & (cos_par < 0.9998) & (cos_par < cos_st)
    st1 = ~tri & (z1d > 0) & (cos_st1 < cos_st2)
    st2 = ~tri & ~st1 & (z2d > 0) & (cos_st2 < cos_st1)
    ok = tri | st1 | st2
    pw = np.zeros((len(pairs), 3))
    if tri.any():
        pw[tri] = triangulate_linear_rows(
            b1[tri], b2[tri], R1[tri], t1[tri], R2[tri], t2[tri]
        )
    if st1.any():  # unproject_stereo role: ray * depth into world
        pw[st1] = kf.Twc.apply(b1[st1] * z1d[st1, None])
    if st2.any():
        pw[st2] = kf2.Twc.apply(b2[st2] * z2d[st2, None])
    p1c = np.einsum("nij,nj->ni", R1, pw) + t1
    p2c = np.einsum("nij,nj->ni", R2, pw) + t2
    ok &= (p1c[:, 2] > 0) & (p2c[:, 2] > 0)
    for kfx, ixs, pc, proj, fish in (
        (kf, i1s, p1c, proj1, fish1),
        (kf2, i2s, p2c, proj2, fish2),
    ):
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = proj(pc)
            e = uv - kfx.kps_un[ixs]
            inv_s2 = kfx.inv_level_sigma2[kfx.octave[ixs]]
            chi = np.einsum("ij,ij->i", e, e) * inv_s2
            stereo_obs = (kfx.u_right[ixs] >= 0) if not fish else np.zeros(len(ixs), bool)
            ur_p = uv[:, 0] - kfx.mbf / pc[:, 2]
            chi_st = chi + (ur_p - kfx.u_right[ixs]) ** 2 * inv_s2
        ok &= np.where(stereo_obs, chi_st <= 7.8, chi <= 5.991)
    d1 = np.linalg.norm(pw - ow1, axis=1)
    d2 = np.linalg.norm(pw - ow2, axis=1)
    ok &= (d1 != 0) & (d2 != 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = d2 / np.where(d1 == 0, 1.0, d1)
        sf = kf.scale_factors[1] / kf.scale_factors[0]
        ratio_oct = (
            kf.scale_factors[kf.octave[i1s]]
            / kf2.scale_factors[kf2.octave[i2s]]
        )
        ok &= (ratio / ratio_oct <= sf * 1.5) & (ratio_oct / ratio <= sf * 1.5)
    return ok, pw, i1s, i2s


class LocalMapping:
    def __init__(self, atlas, monocular: bool = False, sequential: bool = True,
                 imu_calib=None):
        self.atlas = atlas
        self.monocular = monocular
        self.sequential = sequential
        self.imu_calib = imu_calib
        self.tracker = None  # set by System; needed for UpdateFrameIMU role
        self.recent_map_points: list[MapPoint] = []
        self.kf_queue: queue.Queue = queue.Queue()
        self.cur_kf = None
        # LocalMapping::mbAbortBA — set by keyframe insertion / stop
        # requests, polled by the running local BA between LM iterations
        # (the reference's g2o force-stop wiring, LocalMapping.cc:288)
        self.abort_ba = AbortFlag()
        self.n_lba_exec = 0    # nLBA_exec / nLBA_abort (ExecMean.txt role)
        self.n_lba_abort = 0
        self.finished = False
        self.loop_closer = None
        self.kf_database = None
        self._idle = True
        self._accept_kfs = True
        # pause handshake (LocalMapping::RequestStop + isStopped): the worker
        # holds _run_lock while processing a keyframe; request_stop() blocks
        # until the in-flight KF completes and keeps the worker parked until
        # resume().  The reference pauses LocalMapping this way before
        # CorrectLoop / MergeLocal so loop correction cannot race with
        # concurrent triangulation/fusion (src/LoopClosing2.cc:106 region).
        self._run_lock = threading.Lock()

    # --- public API ----------------------------------------------------
    def insert_keyframe(self, kf):
        if self.sequential:
            self.cur_kf = kf
            self._process(kf)
        else:
            self.kf_queue.put(kf)
            self.abort_ba.set()  # interrupt a running local BA

    def interrupt_ba(self):
        """LocalMapping::InterruptBA — the tracker wants the mapper."""
        self.abort_ba.set()

    def accept_keyframes(self) -> bool:
        return self._accept_kfs

    def queue_size(self) -> int:
        return self.kf_queue.qsize()

    def spin(self):
        """Worker-thread loop (LocalMapping::Run)."""
        while not self.finished:
            try:
                kf = self.kf_queue.get(timeout=0.05)
            except queue.Empty:
                continue
            with self._run_lock:
                self._idle = False
                self._accept_kfs = False
                self._process(kf)
                self._accept_kfs = True
                self._idle = True

    def request_stop(self):
        """Block until the worker parks between keyframes, then keep it
        parked (RequestStop + isStopped wait).  Caller must resume().
        Sets abort_ba first so a running local BA yields promptly
        (LocalMapping::RequestStop sets mbAbortBA, LocalMapping.cc:895)."""
        self.abort_ba.set()
        self._run_lock.acquire()

    def resume(self):
        if self._run_lock.locked():
            try:
                self._run_lock.release()
            except RuntimeError:
                pass

    def clear_queue(self):
        while True:
            try:
                self.kf_queue.get_nowait()
            except queue.Empty:
                break

    def request_finish(self):
        self.finished = True

    # --- pipeline -------------------------------------------------------
    def _yield(self):
        """Cooperative GIL yield between pipeline stages (threaded mode).

        The reference relies on OS preemption across >= 4 cores
        (CMakeLists pins -pthread; LocalMapping runs on its own core).  On
        a single-core host the mapper's Python-level stage loops can hold
        the GIL past the tracker's frame deadline, starving Track() into
        LOST (observed: round-4 threaded soak fork).  A zero-length sleep
        releases the GIL at stage boundaries so a mid-frame tracker runs
        promptly; cost on multi-core is a few syscalls per keyframe."""
        if not self.sequential:
            time.sleep(0)

    def _process(self, kf):
        self._process_new_keyframe(kf)
        self._yield()
        self._cull_map_points(kf)
        self._yield()
        self._create_new_map_points(kf)
        self._yield()
        # a fresh cycle starts listening for interrupts here (the reference
        # clears mbAbortBA right after CreateNewMapPoints, LocalMapping.cc:103)
        self.abort_ba.clear()
        if self.sequential or self.kf_queue.empty():
            self._search_in_neighbors(kf)
            self._yield()
            m = self.atlas.get_current_map()
            if m.n_keyframes() > 2 and (self.sequential or self.kf_queue.empty()):
                self.n_lba_exec += 1
                if (
                    self.imu_calib is not None
                    and getattr(m, "imu_initialized", False)
                    and kf.imu_preint is not None
                ):
                    from orbslam3_tpu_torch.optim.local_inertial_ba import (
                        local_inertial_ba,
                    )

                    # the inertial window optimizer is monolithic: hold the
                    # map-update lock across it (solve-unlocked treatment
                    # is the visual path's, below)
                    with m.update_lock:
                        local_inertial_ba(
                            kf, m, self.imu_calib,
                            ba_prior_sigma=(
                                0.03 if not m.iniertial_ba2 else None
                            ),
                            abort_flag=(
                                None if self.sequential else self.abort_ba
                            ),
                        )
                else:
                    # reference lock discipline (Optimizer2.cc:350 region):
                    # graph collection + write-back under mMutexMapUpdate,
                    # the LM solve unlocked so a concurrent Track() is not
                    # starved for the whole BA (the round-4 threaded-soak
                    # failure mode on single-core hosts)
                    local_bundle_adjustment(
                        kf, m,
                        abort_flag=(
                            None if self.sequential else self.abort_ba
                        ),
                        map_lock=None if self.sequential else m.update_lock,
                    )
                if not self.sequential and self.abort_ba:
                    self.n_lba_abort += 1
            self._yield()
            with m.update_lock:
                self._cull_keyframes(kf)
        if self.imu_calib is not None:
            # re-levels/re-scales the whole map + tracker state: exclusive
            with (kf.map or self.atlas.get_current_map()).update_lock:
                self._try_initialize_imu(kf)
                self._maybe_refine_inertial(kf)
        if self.loop_closer is not None:
            self.loop_closer.insert_keyframe(kf)

    def _process_new_keyframe(self, kf):
        fresh = []
        for i, mp in enumerate(kf.map_points):
            if mp is None or mp.bad:
                continue
            if kf not in mp.observations:
                mp.add_observation(kf, i)
                fresh.append(mp)
            else:
                # duplicated during creation: leave for culling watch-list
                self.recent_map_points.append(mp)
        refresh_points(fresh)
        kf.update_connections()
        self.atlas.add_keyframe(kf)
        if self.kf_database is not None:
            self.kf_database.add(kf)

    def _cull_map_points(self, kf):
        """MapPointCulling: drop weak recent points (LocalMapping.cc:346)."""
        cur_id = kf.id
        th_obs = 2 if self.monocular else 3
        keep = []
        for mp in self.recent_map_points:
            if mp.bad:
                continue
            if mp.found_ratio < 0.25:
                mp.set_bad()
            elif cur_id - mp.first_kf_id >= 2 and mp.n_obs <= th_obs:
                mp.set_bad()
            elif cur_id - mp.first_kf_id >= 3:
                pass  # graduated
            else:
                keep.append(mp)
        self.recent_map_points = keep

    def _create_new_map_points(self, kf):
        """Triangulate with best covisible neighbors (LocalMapping.cc:388)."""
        n_neighbors = 10 if not self.monocular else 20
        neighbors = kf.get_best_covisibility_keyframes(n_neighbors)
        m = self.atlas.get_current_map()
        ow1 = kf.camera_center()
        created = 0
        fresh = []
        for kf2 in neighbors:
            if kf2.bad:
                continue
            ow2 = kf2.camera_center()
            baseline = np.linalg.norm(ow2 - ow1)
            if not self.monocular:
                if baseline < kf2.mb:
                    continue
            else:
                depths = [
                    np.linalg.norm(kf2.Tcw * mp.position)
                    for _, mp in kf2.get_map_point_indices()[:50]
                ]
                med = np.median(depths) if depths else 1.0
                if baseline / max(med, 1e-9) < 0.01:
                    continue
            pairs = matchers.search_for_triangulation(kf, kf2)
            if not pairs:
                continue
            ok, pw, i1s, i2s = triangulation_gates(kf, kf2, pairs)
            for j in np.flatnonzero(ok):
                i1, i2 = int(i1s[j]), int(i2s[j])
                mp = MapPoint(pw[j], kf, m)
                mp.add_observation(kf, i1)
                mp.add_observation(kf2, i2)
                kf.add_map_point(mp, i1)
                kf2.add_map_point(mp, i2)
                m.add_map_point(mp)
                self.recent_map_points.append(mp)
                fresh.append(mp)
                created += 1
        refresh_points(fresh)
        return created

    # --- inertial initialization (LocalMapping::InitializeIMU role,
    # ORB_SLAM3/src/LocalMapping.cc:1173) -------------------------
    def _try_initialize_imu(self, kf, min_kfs: int = 6, min_time: float = None):
        """Once the temporal KF chain is long enough, estimate gyro bias,
        gravity, scale and velocities; re-level + re-scale the map
        (Map::ApplyScaledRotation) and mark it VI-initialized."""
        import numpy as np

        from orbslam3_tpu_torch.imu.initialization import (
            gravity_alignment_rotation,
            initialize_imu_chain,
        )
        from orbslam3_tpu_torch.imu.preintegration import Bias
        from orbslam3_tpu_torch.utils.lie import SE3

        import time as _time

        t_start = _time.perf_counter()
        if min_time is None:
            # mono scale is weakly observable: wait longer (the reference
            # gates mono at 2 s vs 1 s stereo, LocalMapping.cc:186-194)
            min_time = 2.0 if self.monocular else 1.0
        m = kf.map if kf.map is not None else self.atlas.get_current_map()
        if getattr(m, "imu_initialized", False):
            return False
        chain = [kf]
        while (
            chain[-1].prev_kf is not None
            and not chain[-1].prev_kf.bad
            and chain[-1].imu_preint is not None
        ):
            chain.append(chain[-1].prev_kf)
        chain.reverse()
        if len(chain) < min_kfs:
            return False
        if chain[-1].timestamp - chain[0].timestamp < min_time:
            return False
        preints = [chain[i + 1].imu_preint for i in range(len(chain) - 1)]
        if any(p is None or p.dT <= 0 for p in preints):
            return False
        Tcb = self.imu_calib.Tbc.inverse()
        Twb = [(k.Twc * Tcb).normalized() for k in chain]
        fix_scale = not self.monocular
        bg, s, g_w, vels = initialize_imu_chain(Twb, preints, fix_scale)
        # sanity gates (the reference gates on observability/accel variance)
        if not np.isfinite(s) or s < 1e-2 or s > 1e2:
            return False
        if abs(np.linalg.norm(g_w) - 9.81) > 2.5:
            return False
        if np.linalg.norm(bg) > 1.0:
            return False
        if not fix_scale:
            # mono scale suffers errors-in-variables attenuation on noisy
            # early maps: only trust it once two consecutive windows agree
            prev_s = getattr(m, "_mono_s_estimate", None)
            m._mono_s_estimate = s
            if prev_s is None or abs(s / prev_s - 1.0) > 0.1:
                return False
        r_gw = gravity_alignment_rotation(g_w)
        scale = 1.0 if fix_scale else float(s)
        t_align = SE3(r_gw, np.zeros(3))
        m.apply_scaled_rotation(t_align, scale, scale_vel=True)
        bias = Bias(np.zeros(3), bg)
        for k, v in zip(chain, vels):
            # align_visual_inertial's velocities are already METRIC (its
            # velocity rows carry no scale factor, unlike the reference's
            # EdgeInertialGS where v is map-scale and ApplyScaledRotation
            # multiplies by s afterwards) — only rotate into the re-leveled
            # frame.  Scaling here double-applied s and corrupted the seed
            # states that ScaleRefinement/VIBA1 start from.
            k.velocity = r_gw @ v
            k.imu_bias = bias.copy()
            if k.imu_preint is not None:
                k.imu_preint.set_new_bias(bias)
        # give every other KF of the map a velocity estimate by differencing
        for k in m.get_all_keyframes():
            if k.velocity is None and k.prev_kf is not None and k.prev_kf.velocity is not None:
                k.velocity = k.prev_kf.velocity.copy()
                k.imu_bias = bias.copy()
        m.imu_initialized = True
        m.is_inertial = True
        m.imu_init_time = kf.timestamp  # System::GetTimeFromIMUInit anchor
        # VI-init diagnostics for System.save_debug_data (the reference's
        # mScale/mRwg/mbg/mba/mCostTime/mInitSect, LocalMapping.h + the
        # SaveDebugData dump at System.cc:1219)
        self.init_sect = getattr(self, "init_sect", 0) + 1
        self.init_debug = dict(
            scale=scale,
            Rwg=np.asarray(r_gw.matrix() if hasattr(r_gw, "matrix") else r_gw),
            bg=np.asarray(bg, dtype=float),
            ba=np.zeros(3),
            cost_time=_time.perf_counter() - t_start,
        )
        if self.tracker is not None:
            self.tracker.update_frame_imu(t_align, scale, bias, kf)
        m.info_changed()
        return True

    def _maybe_refine_inertial(self, kf, viba1_at: int = 15, viba2_at: int = 30):
        """Staged full-map VI refinement after initialization (the
        reference's VIBA1/VIBA2 passes, LocalMapping.cc:210-241): once the
        temporal chain is long enough, run FullInertialBA and mark the
        map's inertial-BA stage flags."""
        m = kf.map if kf.map is not None else self.atlas.get_current_map()
        if not getattr(m, "imu_initialized", False):
            return
        n = 1
        k = kf
        chain = [kf]
        while k.prev_kf is not None and not k.prev_kf.bad and k.imu_preint is not None:
            n += 1
            k = k.prev_kf
            chain.append(k)
        from orbslam3_tpu_torch.optim.global_ba import full_inertial_ba

        if self.monocular and not m.iniertial_ba1:
            # ScaleRefinement role (LocalMapping.cc:1429) until VIBA1: the
            # joint chain pass with an explicit landmark-scale variable
            # (poses free -> no errors-in-variables bias; a poses-fixed
            # linear re-alignment systematically shrinks the estimate)
            self._scale_refinement(m, kf)
        if not m.iniertial_ba1 and n >= viba1_at:
            out = full_inertial_ba(m, self.imu_calib, opt_scale=self.monocular,
                                   ba_prior_sigma=0.03)
            self._after_map_scale(out, kf)
            m.iniertial_ba1 = True
        elif m.iniertial_ba1 and not m.iniertial_ba2 and n >= viba2_at:
            out = full_inertial_ba(m, self.imu_calib, opt_scale=self.monocular)
            self._after_map_scale(out, kf)
            m.iniertial_ba2 = True

    def _after_map_scale(self, out, kf):
        """Re-anchor the tracker when a refinement rescaled the map."""
        if not isinstance(out, tuple):
            return
        _n, s_total, center = out
        if abs(s_total - 1.0) > 1e-6 and self.tracker is not None:
            from orbslam3_tpu_torch.utils.lie import SE3

            # scale about `center`: twc' = s*twc + (1-s)*c
            t_corr = SE3(t=(1.0 - s_total) * center)
            self.tracker.update_frame_imu(
                t_corr, float(s_total), kf.imu_bias, kf
            )

    def _scale_refinement(self, m, kf, window: int = 12):
        """Joint scale-aware chain pass over the recent window; applies the
        solved landmark scale to the whole map + tracker."""
        import numpy as np

        from orbslam3_tpu_torch.optim.local_inertial_ba import (
            NavState,
            optimize_inertial_window,
        )
        from orbslam3_tpu_torch.utils.lie import SE3

        chain = [kf]
        while (
            len(chain) < window
            and chain[-1].prev_kf is not None
            and not chain[-1].prev_kf.bad
            and chain[-1].imu_preint is not None
        ):
            chain.append(chain[-1].prev_kf)
        chain.reverse()
        if len(chain) < 6:
            return
        preints = [chain[i + 1].imu_preint for i in range(len(chain) - 1)]
        if any(p is None or p.dT <= 0 for p in preints):
            return
        Tbc = self.imu_calib.Tbc
        Tcb = Tbc.inverse()
        states = []
        for k in chain:
            Twb = (k.Twc * Tcb).normalized()
            states.append(
                NavState(
                    Twb.R, Twb.t,
                    k.velocity if k.velocity is not None else np.zeros(3),
                    k.imu_bias.bg.copy(), k.imu_bias.ba.copy(),
                )
            )
        kf_idx, pw, uv, ur, is2 = [], [], [], [], []
        for i, k in enumerate(chain):
            for j, mp in k.get_map_point_indices():
                kf_idx.append(i)
                pw.append(mp.position)
                uv.append(k.kps_un[j])
                ur.append(k.u_right[j])
                is2.append(k.inv_level_sigma2[k.octave[j]])
        if len(kf_idx) < 50:
            return
        obs = dict(
            kf_idx=np.asarray(kf_idx), pw=np.asarray(pw, np.float64),
            uv=np.asarray(uv, np.float64), ur=np.asarray(ur, np.float64),
            inv_sigma2=np.asarray(is2, np.float64),
            camera=kf.camera, mbf=kf.mbf,
        )
        fixed = np.zeros(len(chain), bool)
        fixed[0] = True
        states, _, s_corr, s_center = optimize_inertial_window(
            states, preints, obs, Tcb, fixed, opt_scale=True,
            ba_prior_sigma=0.03,
        )
        if not np.isfinite(s_corr) or not (0.5 < s_corr < 2.0):
            return
        from orbslam3_tpu_torch.imu.preintegration import Bias

        for k, s in zip(chain, states):
            Twb = SE3(s.R, s.p).normalized()
            k.set_pose((Twb * Tbc).inverse())
            k.velocity = s.v.copy()
            k.imu_bias = Bias(s.ba.copy(), s.bg.copy())
        if abs(s_corr - 1.0) > 1e-6:
            chain_set = set(chain)
            for mp in m.get_all_map_points():
                mp.position = s_center + s_corr * (mp.position - s_center)
                mp.update_normal_and_depth()
            for k in m.get_all_keyframes():
                if k in chain_set or k.bad:
                    continue
                twc = k.Twc
                k.set_pose(
                    SE3(twc.R, s_center + s_corr * (twc.t - s_center)).inverse()
                )
                if k.velocity is not None:
                    k.velocity = k.velocity * s_corr
            if self.tracker is not None:
                t_corr = SE3(t=(1.0 - s_corr) * s_center)
                self.tracker.update_frame_imu(
                    t_corr, float(s_corr), kf.imu_bias, kf
                )
            m.info_changed()

    def _search_in_neighbors(self, kf):
        """Fuse duplicates with 1st/2nd-order neighbors (LocalMapping.cc:714)."""
        n = 10 if not self.monocular else 30
        targets = []
        seen = set()
        for k1 in kf.get_best_covisibility_keyframes(n):
            if k1.bad or k1 in seen:
                continue
            targets.append(k1)
            seen.add(k1)
            for k2 in k1.get_best_covisibility_keyframes(5):
                if not k2.bad and k2 not in seen and k2 is not kf:
                    targets.append(k2)
                    seen.add(k2)
        own = [mp for _, mp in kf.get_map_point_indices()]
        for k in targets:
            matchers.fuse(k, own)
        if not self.sequential and self.abort_ba:
            # keyframe insertion interrupted the cycle (the reference
            # returns between the two fuse directions, LocalMapping.cc:777)
            return
        fuse_candidates = []
        cand_seen = set()
        for k in targets:
            for _, mp in k.get_map_point_indices():
                if mp.id not in cand_seen:
                    cand_seen.add(mp.id)
                    fuse_candidates.append(mp)
        matchers.fuse(kf, fuse_candidates)
        refresh_points([mp for _, mp in kf.get_map_point_indices()])
        kf.update_connections()

    def _cull_keyframes(self, kf):
        """Drop KFs with >=90% redundant observations (LocalMapping.cc:902).

        Vectorized over the observation graph: per candidate KF, flatten its
        points' observations C-speed (hostops) and count same-or-finer-scale
        observers per point with one bincount — same redundancy decision as
        the reference's triple loop (>= th_obs observers at octave <=
        scale_level + 1 over depth-eligible points)."""
        from orbslam3_tpu_torch.native import hostops

        th_obs = 3
        n_checked = 0
        for k in kf.get_best_covisibility_keyframes(100):
            n_checked += 1
            if n_checked > 20 and not self.sequential and self.abort_ba:
                break  # reference: (count > 20 && mbAbortBA) -> stop culling
            if k.bad or k.id == (k.map.init_kf_id if k.map is not None else 0):
                continue
            pairs = k.get_map_point_indices()
            if not pairs:
                continue
            idx_arr = np.fromiter((i for i, _ in pairs), np.int64, len(pairs))
            mps = [mp for _, mp in pairs]
            if not self.monocular:
                d = k.depth[idx_arr]
                elig = (d <= k.mb * 35) & (d >= 0)
            else:
                elig = np.ones(len(pairs), bool)
            n_mps = int(elig.sum())
            if n_mps == 0:
                continue
            counts = hostops.obs_counts(mps)
            cand = np.nonzero(elig & (hostops.n_obs_of(mps) > th_obs)
                              & (counts > 0))[0]
            if 0.9 * n_mps >= len(cand):
                continue  # even all-redundant candidates can't cross 90%
            sub = [mps[i] for i in cand]
            _, _, grp, kfi, left_a, right_a, obs_kfs = hostops.collect_obs(sub)
            ok_kf = np.fromiter(
                (not (o is k or o.bad) for o in obs_kfs), bool, count=len(obs_kfs)
            )
            i_e = np.where(left_a >= 0, left_a, right_a)
            edge_ok = ok_kf[kfi] & (i_e >= 0) if len(kfi) else np.zeros(0, bool)
            oct_e = np.zeros(len(grp), np.int64)
            i_safe = np.maximum(i_e, 0)
            # group edges by KF with one argsort (O(E log E), not O(E x KFs))
            order = np.argsort(kfi, kind="stable")
            kfi_s = kfi[order]
            bounds = np.r_[0, np.nonzero(np.diff(kfi_s))[0] + 1, len(kfi_s)]
            for b0, b1 in zip(bounds[:-1], bounds[1:]):
                sel = order[b0:b1]
                sel = sel[edge_ok[sel]]
                if len(sel):
                    oct_e[sel] = obs_kfs[int(kfi_s[b0])].octave[i_safe[sel]]
            scale_lv = k.octave[idx_arr[cand]]
            better = edge_ok & (oct_e <= scale_lv[grp] + 1)
            nb = np.bincount(grp[better], minlength=len(sub))
            n_redundant = int((nb >= th_obs).sum())
            if n_redundant > 0.9 * n_mps:
                k.set_bad()
