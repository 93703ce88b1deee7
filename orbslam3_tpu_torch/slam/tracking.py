"""Tracking: the per-frame pose estimation state machine.

Role-parity with ORB_SLAM3/include/Tracking.h + src/Tracking1-5.cc
(4,299 LoC): states NO_IMAGES_YET -> NOT_INITIALIZED -> OK / RECENTLY_LOST /
LOST (Tracking.h:121); stereo initialization (Tracking3.cc:584); motion-model
and reference-KF tracking (Tracking4.cc:178,44); TrackLocalMap
(Tracking4.cc:273) with frustum-gated local-point search; keyframe decision
(Tracking4.cc:388) and creation with stereo-depth map points
(Tracking4.cc:540); relocalization hook; multi-map recovery via the Atlas
(new map on LOST, SURVEY §5.3).  The device front-end supplies keypoints/
descriptors/stereo depths; everything here is host-side NumPy.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np

from orbslam3_tpu_torch.native import hostops
from orbslam3_tpu_torch.optim.pose_optimization import PoseObservations, pose_optimization
from orbslam3_tpu_torch.slam import matchers
from orbslam3_tpu_torch.slam.frame import Frame
from orbslam3_tpu_torch.slam.keyframe import KeyFrame
from orbslam3_tpu_torch.slam.map_point import MapPoint, refresh_points
from orbslam3_tpu_torch.utils.benchmark import Benchmark, clock_ns, off_cpu, trace_range
from orbslam3_tpu_torch.utils.lie import SE3


class TrackingState(IntEnum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


class Tracking:
    def __init__(
        self,
        atlas,
        local_mapper,
        camera,
        mbf: float,
        depth_threshold_factor: float = 35.0,
        min_frames: int = 0,
        max_frames: int = 30,
        relocalizer=None,
        imu_calib=None,
        *,
        device,
    ):
        # torch device of the dense local-map matcher (the System's own)
        self.device = device
        self.atlas = atlas
        self.local_mapper = local_mapper
        self.camera = camera
        self.mbf = mbf
        self.mb = mbf / camera.fx
        self.depth_th = self.mb * depth_threshold_factor
        self.min_frames = min_frames
        self.max_frames = max_frames
        self.relocalizer = relocalizer
        # inertial configuration (Tbc + noise); None = visual-only
        self.imu_calib = imu_calib
        self._imu_meas_since_kf: list = []

        self.state = TrackingState.NO_IMAGES_YET
        self.velocity: SE3 | None = None
        self.last_frame: Frame | None = None
        self.current: Frame | None = None
        self.ref_kf: KeyFrame | None = None
        self.last_kf: KeyFrame | None = None
        self.last_kf_frame_id = 0
        self.last_reloc_frame_id = 0
        self.matches_inliers = 0
        self._last_inliers = 0
        # deviation knobs (VERDICT r1 weak-5; see matchers.set_tuning):
        # tuned on the synthetic world, overridable via Settings Tuning.*
        self.mono_init_min_matches = 60       # reference: 100 (at 5x features)
        self.vo_points_in_final_vote = False  # reference keeps VO points
        # localization-only mode (mbOnlyTracking role): no new keyframes,
        # map frozen
        self.only_tracking = False
        self.local_kfs: list[KeyFrame] = []
        self.local_mps: list[MapPoint] = []
        # local-map union cache: (kf.id, kf._mp_version) fingerprint of
        # local_kfs; while no member KF's map-point slots changed, the
        # deduped union is reused across frames
        self._local_map_key: list | None = None
        # per-frame slot cache for local_mps: valid only within one frame
        # (tracking holds the map update lock for the whole frame, so no
        # attach/detach can reuse a slot mid-frame; cleared at frame start)
        self._local_slots: np.ndarray | None = None
        self._local_slots_table = None
        self.temporal_points: list[MapPoint] = []
        self.frames_since_lost = 0
        self._time_stamp_lost = 0.0  # mTimeStampLost (Tracking3.cc:270)
        # RECENTLY_LOST patience before LOST: the reference holds inertial
        # modes for time_recently_lost (member, 5.0 s; Tracking1.cc:48) and
        # visual-only for a hardcoded 3.0 s (Tracking3.cc:255)
        self.time_recently_lost = 5.0
        self.time_recently_lost_visual = 3.0
        # the keyframe handoff: frames whose visual conditions want a
        # keyframe, and the keyframes inserted (n_kf_refused_busy: the rest)
        self.n_kf_wanted = 0
        self.n_kf_inserted = 0

        # trajectory log: (frame_id, timestamp, Tcr relative to ref KF, ref KF, lost)
        self.trajectory: list = []

    @property
    def n_kf_refused_busy(self) -> int:
        """Keyframes wanted but refused because the mapper was busy: its
        stereo queue held 3, or (monocular) it was not idle."""
        return self.n_kf_wanted - self.n_kf_inserted

    # ------------------------------------------------------------------
    def track_frame(self, frame: Frame) -> SE3 | None:
        """Per-frame entry (Tracking::Track, Tracking3.cc:44), under the
        spans `2_Track` and `2_Track.offcpu`."""
        with trace_range("2_Track", self.device, frame=getattr(frame, "id", None)), \
                off_cpu("2_Track.offcpu"):
            self.current = frame
            pre = getattr(frame, "imu_preint", None)
            if pre is not None:
                # accumulate raw samples for the next keyframe's preintegration
                # (Tracking::PreintegrateIMU keeps mpImuPreintegratedFromLastKF)
                self._imu_meas_since_kf.extend(pre.measurements)
            # slot caches are only valid while the update lock is held
            self._local_slots = None
            self._local_slots_table = None
            # map-update lock for the whole frame (Tracking3.cc:135): excludes
            # concurrent loop correction / merge in threaded mode; reentrant
            # no-op in sequential mode.  A merge that ran while the frame waited
            # has made another map the current one: take that map's lock
            # instead.  The wait for the lock, retries summed, is one
            # `2.0_Track.map_lock` span.
            asked, waited = clock_ns(), 0
            while True:
                m = self.atlas.get_current_map()
                t = clock_ns()
                with m.update_lock:
                    waited += clock_ns() - t
                    if self.atlas.get_current_map() is m:
                        Benchmark.the().push_sample("2.0_Track.map_lock", waited / 1e6, asked)
                        pose = self._track_frame_locked(frame)
                        break
            # sequential mode: the loop closer takes the frame's keyframes now
            # that the frame is logged (LoopClosing.insert_keyframe)
            if self.local_mapper.loop_closer is not None:
                self.local_mapper.loop_closer.run_held()
        return pose

    def _track_frame_locked(self, frame: Frame) -> SE3 | None:
        # timestamp-jump detection (Tracking3.cc:66-104): a frame older than
        # its predecessor forks a fresh map; a >1 s gap on an inertial map
        # resets/forks (the preintegration across the gap is garbage)
        lf = self.last_frame
        if self.state != TrackingState.NO_IMAGES_YET and lf is not None:
            if frame.timestamp < lf.timestamp:
                self._imu_meas_since_kf = []
                self._fork_map()
                return None
            if frame.timestamp > lf.timestamp + 1.0 and self.imu_calib is not None:
                m = self.atlas.get_current_map()
                if getattr(m, "imu_initialized", False) and getattr(
                    m, "iniertial_ba2", False
                ):
                    self._fork_map()
                else:
                    self._reset_active_map()
                return None
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            if self.mbf > 0:
                self._stereo_initialization(frame)
            else:
                self._monocular_initialization(frame)
            self.last_frame = frame
            if self.state == TrackingState.OK:
                self._log_trajectory(lost=False)
            return frame.Tcw.copy() if frame.Tcw is not None else None

        ok = False
        with trace_range("2.1_Track.pose", self.device):
            if self.state == TrackingState.OK:
                self._check_replaced_in_last_frame()
                if self.velocity is None or frame.id < self.last_reloc_frame_id + 2:
                    ok = self._track_reference_keyframe()
                else:
                    ok = self._track_with_motion_model()
                    if not ok:
                        ok = self._track_reference_keyframe()
            elif self.state == TrackingState.RECENTLY_LOST:
                # IMU dead-reckoning first (Tracking::PredictStateIMU path,
                # Tracking2.cc:565): predict through the preintegration window
                # and try to re-acquire the map at the predicted pose
                ok = self._predict_with_imu(frame) and self._reacquire_at_prediction()
                if not ok:
                    ok = self._relocalize()
                self.frames_since_lost += 1
                # TIME-based patience (Tracking3.cc:242-260): visual-only gives
                # relocalization 3.0 s from the loss timestamp; inertial rides
                # IMU prediction for time_recently_lost (5.0 s) before LOST.
                patience = (
                    self.time_recently_lost
                    if self.imu_calib is not None
                    else self.time_recently_lost_visual
                )
                if not ok and frame.timestamp - self._time_stamp_lost > patience:
                    self.state = TrackingState.LOST

        if self.state == TrackingState.LOST:
            self._handle_lost()
            self.last_frame = frame
            self._log_trajectory(lost=True)
            return None

        if ok:
            with trace_range("2.2_Track.local_map", self.device):
                ok = self._track_local_map()
        if ok:
            self.state = TrackingState.OK
            self.frames_since_lost = 0
        elif self.state == TrackingState.OK:
            self.state = TrackingState.RECENTLY_LOST
            self.frames_since_lost = 0
            self._time_stamp_lost = frame.timestamp
            self._imu_prior = None  # chain broken; restart from next anchor

        if ok:
            # last_frame can be None on the first frame after an atlas
            # load (multi-session resume relocalizes with no predecessor)
            if self.last_frame is not None and self.last_frame.Tcw is not None:
                self.velocity = frame.Tcw * self.last_frame.Twc
            else:
                self.velocity = None
            self._update_velocity_estimate(frame)
            if self.imu_calib is not None:
                # keep a VI state on every tracked frame so the next frame's
                # inertial optimization has a previous state to bind to
                if getattr(frame, "imu_bias", None) is None:
                    frame.imu_bias = self.current_bias()
                if getattr(frame, "velocity", None) is None and getattr(self, "_v_w", None) is not None:
                    frame.velocity = self._v_w.copy()
            self._clean_vo_matches()
            with trace_range("2.3_Track.keyframe", self.device):
                if self._need_new_keyframe():
                    self.n_kf_inserted += 1
                    self._create_new_keyframe()
            # drop outlier associations (pose-opt marked)
            for i in np.nonzero(frame.outlier)[0]:
                frame.map_points[i] = None
                frame.outlier[i] = False
            # Delete temporal VO points (Tracking4.cc deletes
            # mlpTemporalPoints every tracked frame): _clean_vo_matches just
            # nulled every n_obs<1 association from the current frame, and
            # the previous frame (the only other holder) is dropped below,
            # so the objects free now instead of accumulating per frame.
            for mp in self.temporal_points:
                mp.bad = True
            self.temporal_points.clear()
        frame.ref_keyframe = self.ref_kf
        self._log_trajectory(lost=not ok)
        self.last_frame = frame
        return frame.Tcw.copy() if ok and frame.Tcw is not None else None

    # ------------------------------------------------------------------
    def _log_trajectory(self, lost: bool):
        f = self.current
        if f.Tcw is not None and self.ref_kf is not None:
            tcr = f.Tcw * self.ref_kf.Twc
        else:
            tcr = SE3()
        self.trajectory.append((f.id, f.timestamp, tcr, self.ref_kf, lost))

    @staticmethod
    def _right_slot_of(frame, i: int) -> int:
        """Global slot index of the right-camera keypoint stereo-matched to
        left keypoint i, or -1 (fisheye frames only)."""
        l2r = getattr(frame, "left_to_right", None)
        if l2r is None or i >= frame.n_left or l2r[i] < 0:
            return -1
        return frame.n_left + int(l2r[i])

    def _stereo_initialization(self, frame: Frame):
        """Tracking3.cc:584: needs >500 kps; map from stereo depths."""
        if frame.n <= 500:
            return
        frame.set_pose(SE3())
        m = self.atlas.get_current_map()
        kf = KeyFrame(frame, m)
        m.add_keyframe(kf)
        n_pts = 0
        for i in range(frame.n):
            z = frame.depth[i]
            if z <= 0:
                continue
            pw = kf.unproject_stereo(i)
            if pw is None:
                continue
            mp = MapPoint(pw, kf, m)
            mp.add_observation(kf, i)
            kf.add_map_point(mp, i)
            frame.map_points[i] = mp
            # fisheye: the matched right keypoint is a second first-class
            # observation of the same point (mvpMapPoints[Nleft + match])
            j = self._right_slot_of(frame, i)
            if j >= 0:
                mp.add_observation(kf, j)
                kf.add_map_point(mp, j)
                frame.map_points[j] = mp
            mp.compute_distinctive_descriptor()
            mp.update_normal_and_depth()
            m.add_map_point(mp)
            n_pts += 1
        if n_pts < 100:
            return
        self._attach_imu_to_kf(kf)
        self.local_mapper.insert_keyframe(kf)
        self.ref_kf = kf
        self.last_kf = kf
        self.last_kf_frame_id = frame.id
        self.local_kfs = [kf]
        self.local_mps = m.get_all_map_points()
        self.state = TrackingState.OK

    def _set_ini_frame(self, frame: Frame | None):
        """(Re)seed the monocular-initialization reference frame.  The
        kf1->kf2 preintegration attached at init must start AT the reference
        frame — keep only IMU samples that arrived with frames after it (the
        reference rebuilds mpImuPreintegratedFromLastKF at init)."""
        self._ini_frame = frame
        self._imu_meas_since_kf = []

    def _monocular_initialization(self, frame: Frame):
        """Two-view monocular init (Tracking::MonocularInitialization):
        match against a reference frame, reconstruct with F/H model
        selection, normalize scale to median depth 1, spawn two keyframes
        and the initial map."""
        from orbslam3_tpu_torch.optim.two_view import TwoViewReconstruction

        if getattr(self, "_ini_frame", None) is None or frame.n <= 100:
            self._set_ini_frame(frame if frame.n > 100 else None)
            self.state = TrackingState.NOT_INITIALIZED
            return
        ini = self._ini_frame
        m12 = matchers.search_for_initialization(ini, frame, window=100)
        matched = np.nonzero(m12 >= 0)[0]
        # gate: the reference requires >100 matches but extracts 5x features
        # for initialization (mpIniORBextractor, nFeatures*5); at our 1x
        # budget the equivalent gate is ~60 level-0 matches
        if len(matched) < self.mono_init_min_matches:
            self._set_ini_frame(frame if frame.n > 100 else None)
            return
        tvr = TwoViewReconstruction(frame.camera)
        ok, T21, pts, good = tvr.reconstruct(
            ini.kps_un[matched], frame.kps_un[m12[matched]]
        )
        if not ok or good.sum() < 50:
            return
        # normalize scale: median depth -> 1, or -> 4 for mono-inertial
        # (reference CreateInitialMapMonocular, Tracking3.cc:833-836: the
        # IMU configuration starts the arbitrary map scale nearer metric for
        # typical indoor scenes, conditioning the upcoming VI alignment)
        med = float(np.median(pts[good][:, 2]))
        if med <= 0:
            return
        target = 4.0 if self.imu_calib is not None else 1.0
        pts = pts * (target / med)
        T21 = SE3(T21.R, T21.t * (target / med))
        ini.set_pose(SE3())
        frame.set_pose(T21)
        m = self.atlas.get_current_map()
        kf1 = KeyFrame(ini, m)
        kf2 = KeyFrame(frame, m)
        m.add_keyframe(kf1)
        m.add_keyframe(kf2)
        for k in np.nonzero(good)[0]:
            i1 = int(matched[k])
            i2 = int(m12[matched][k])
            mp = MapPoint(pts[k], kf2, m)
            mp.add_observation(kf1, i1)
            mp.add_observation(kf2, i2)
            kf1.add_map_point(mp, i1)
            kf2.add_map_point(mp, i2)
            frame.map_points[i2] = mp
            mp.compute_distinctive_descriptor()
            mp.update_normal_and_depth()
            m.add_map_point(mp)
        kf1.update_connections()
        kf2.update_connections()
        self.last_kf = kf1
        self._attach_imu_to_kf(kf2)
        self.local_mapper.insert_keyframe(kf1)
        self.local_mapper.insert_keyframe(kf2)
        self.ref_kf = kf2
        self.last_kf = kf2
        self.last_kf_frame_id = frame.id
        self.local_kfs = [kf1, kf2]
        self.local_mps = m.get_all_map_points()
        self._ini_frame = None
        self.state = TrackingState.OK

    def _check_replaced_in_last_frame(self):
        lf = self.last_frame
        for i in range(lf.n):
            mp = lf.map_points[i]
            if mp is not None and mp.replaced_by is not None:
                lf.map_points[i] = mp.get_replaced()

    def _update_last_frame(self):
        """Re-anchor last frame pose; spawn temporal VO points for close
        stereo keypoints (Tracking4.cc UpdateLastFrame)."""
        lf = self.last_frame
        if lf.ref_keyframe is not None and self.trajectory:
            tcr = next(
                (t for t in reversed(self.trajectory) if t[0] == lf.id), None
            )
            if tcr is not None and tcr[3] is not None:
                lf.set_pose(tcr[2] * tcr[3].Tcw)
        if self.mbf <= 0 or lf.id == self.last_kf_frame_id:
            return
        # create temporal points for the closest 100 (or all close) depths
        z = lf.depth
        cand = np.nonzero(z > 0)[0]
        if len(cand) == 0:
            return
        order = cand[np.argsort(z[cand])]
        # vectorized form of the reference's create-closest-first loop
        # (process in depth order, stop after the first point that is both
        # beyond depth_th and past 100 creations)
        mps = lf.map_points
        need_new = hostops.n_obs_of(mps[order]) < 1
        stop = (z[order] > self.depth_th) & (np.cumsum(need_new) > 100)
        end = int(np.argmax(stop)) + 1 if stop.any() else len(order)
        new_idx = order[:end][need_new[:end]]
        if len(new_idx) == 0:
            return
        fresh = MapPoint.new_temporal_batch(
            lf.unproject_stereo_batch(new_idx), lf.desc[new_idx]
        )
        mps[new_idx] = fresh
        self.temporal_points.extend(fresh)

    def _track_with_motion_model(self) -> bool:
        self._update_last_frame()
        f = self.current
        f.set_pose(self.velocity * self.last_frame.Tcw)
        f.map_points[:] = None
        th = 7 if self.mbf > 0 else 15
        # fisheye disables the forward/backward octave heuristics (the
        # reference's SearchByProjection gates them on Nleft == -1) and adds
        # a right-camera pass through the right-view pseudo-frame
        import os

        dual = (
            f.camera2 is not None
            and os.environ.get("ORBSLAM3_TPU_DUAL_MM", "1") == "1"
        )
        mono = self.mbf <= 0 or f.camera2 is not None
        n = self._mm_search(f, th, mono, dual)
        if n < 20:
            f.map_points[:] = None
            n = self._mm_search(f, 2 * th, mono, dual)
        if n < 20:
            return False
        return self._optimize_current_pose() >= 10

    def _mm_search(self, f, th, mono, dual) -> int:
        """Motion-model projection search; for fisheye, the left and right
        passes share ONE rotation-consistency histogram (the reference's
        single rotHist across the left and bRight blocks)."""
        import os

        if not dual:
            return matchers.search_by_projection_last_frame(
                f, self.last_frame, th, mono
            )
        col: list = []
        n = matchers.search_by_projection_last_frame(
            f, self.last_frame, th, mono, rot_collect=col
        )
        n += matchers.search_by_projection_last_frame(
            f.right_view(), self.last_frame, th, True, rot_collect=col
        )
        if col:
            keep = matchers._rotation_consistency(
                [r for _, _, r in col], list(range(len(col)))
            )
            for k, (fr, i, _) in enumerate(col):
                if k not in keep:
                    fr.map_points[i] = None
                    n -= 1
        return n

    def _track_reference_keyframe(self) -> bool:
        f = self.current
        if self.ref_kf is None:
            return False
        matches, n = matchers.search_by_bow(self.ref_kf, f, ratio=0.7)
        if n < 15:
            return False
        f.map_points[:] = None
        for j, mp in matches.items():
            f.map_points[j] = mp
        f.set_pose(self.last_frame.Tcw if self.last_frame.Tcw is not None else SE3())
        return self._optimize_current_pose() >= 10

    def _optimize_current_pose(self, map_only: bool = False) -> int:
        f = self.current
        objs = f.map_points
        nz = np.nonzero(objs != None)[0]  # noqa: E711 — elementwise over objects
        if len(nz) < 3:
            return 0
        mps = objs[nz]
        table = self.atlas.get_current_map().landmarks
        slots = table.slots_of(mps)
        att = slots >= 0
        sl = np.maximum(slots, 0)
        # attached: table.valid mirrors `not bad`; unattached (temporal VO
        # points): batched bad check (obs_counts is -1 exactly when bad).
        # map_only keeps map-anchored (n_obs > 0) points only — temporals
        # are n_obs == 0 by definition.
        good = att & table.valid[sl]
        if not att.all():
            ua = np.nonzero(~att)[0]
            good[ua] = hostops.obs_counts(mps[ua]) >= 0
        if map_only:
            good &= att & (table.n_obs[sl] > 0)
        keep = np.nonzero(good)[0]
        if len(keep) < 3:
            return 0
        idx = nz[keep]
        p3d = table.pos[sl[keep]].copy()
        if not att.all():
            ua = np.nonzero(~att[keep])[0]
            if len(ua):  # unattached survivors read their own position
                p3d[ua] = np.stack(
                    [mp._position for mp in mps[keep[ua]]]
                )
        obs = PoseObservations(
            p3d_w=p3d,
            obs_uv=f.kps_un[idx],
            obs_ur=f.u_right[idx],
            inv_sigma2=f.inv_level_sigma2[f.octave[idx]],
            camera=f.camera,
            mbf=f.mbf,
            # fisheye dual-camera: slots >= n_left are right-camera
            # observations -> body-frame (Trl) reprojection edges
            is_right=(idx >= f.n_left) if f.camera2 is not None else None,
            camera2=f.camera2,
            Trl=f.Trl,
        )
        T, inlier, n_in = pose_optimization(f.Tcw, obs)
        import os as _os
        if _os.environ.get("ORBSLAM3_TPU_DEBUG_DUAL") == "1" and f.camera2 is not None:
            ir = np.asarray(idx >= f.n_left)
            inl = np.asarray(inlier, bool)
            print(f"[dual] frame {f.id} map_only={map_only} edges L={int((~ir).sum())} R={int(ir.sum())} "
                  f"inl L={int(inl[~ir].sum())} R={int(inl[ir].sum())}", flush=True)
        f.set_pose(T)
        # Mark outliers but KEEP the associations (reference semantics:
        # mvbOutlier flags live through Track(); nulling here would prune
        # truth-consistent matches that merely look bad from a drifted
        # intermediate pose, biasing later stages toward the drift).
        f.outlier[:] = False
        f.outlier[idx[~np.asarray(inlier, bool)]] = True
        return n_in

    # --- local map -------------------------------------------------------
    def _track_local_map(self) -> bool:
        f = self.current
        self._update_local_map()
        self._search_local_points()
        # Final pose vote comes from MAP-ANCHORED points only.  Temporal VO
        # points are anchored to the last frame's *estimate*; letting them
        # vote here couples the pose to its own history along the weakly
        # observable (x, yaw)/(y, pitch) modes, and together with the
        # constant-velocity extrapolation (gain 2 along those modes) the
        # loop e_{t+1} ~ 2 e_t - e_{t-1} is unstable.  (The reference keeps
        # them; its scenes are stiff enough that the loop gain stays < 1.)
        n_in = self._optimize_current_pose(map_only=not self.vo_points_in_final_vote)
        # Escalation: if the pose landed with weak support relative to the
        # previous frame, the drift likely exceeded the th=1 search window —
        # redo the local search wider and re-optimize (the reference's
        # RECENTLY_LOST th=15 escalation, applied one step earlier).
        if n_in < 0.6 * max(self._last_inliers, 1) or n_in < 60:
            self._search_local_points(th=5)
            n_in = self._optimize_current_pose(map_only=not self.vo_points_in_final_vote)
        # IMU fusion of the final pose (after visual outlier classification)
        self._refine_pose_inertial()
        # count only real map points (bump n_found on every inlier)
        self.matches_inliers = hostops.count_found(f.map_points, f.outlier)
        self._last_inliers = self.matches_inliers
        if f.id < self.last_reloc_frame_id + self.max_frames and self.matches_inliers < 50:
            return False
        return self.matches_inliers >= 30

    def _update_local_map(self):
        """UpdateLocalKeyFrames + UpdateLocalPoints (Tracking4.cc:273+)."""
        f = self.current
        counter: dict[KeyFrame, int] = hostops.count_obs_kfs(f.map_points)
        if not counter:
            return
        self.local_kfs = []
        seen = set()
        kf_max = max(counter.items(), key=lambda kv: kv[1])[0]
        for kf in sorted(counter, key=lambda k: -counter[k]):
            self.local_kfs.append(kf)
            seen.add(kf)
        for kf in list(self.local_kfs):
            if len(self.local_kfs) > 80:
                break
            for nb in kf.get_best_covisibility_keyframes(10):
                if not nb.bad and nb not in seen:
                    self.local_kfs.append(nb)
                    seen.add(nb)
                    break
            for ch in kf.children:
                if not ch.bad and ch not in seen:
                    self.local_kfs.append(ch)
                    seen.add(ch)
                    break
            if kf.parent is not None and kf.parent not in seen and not kf.parent.bad:
                self.local_kfs.append(kf.parent)
                seen.add(kf.parent)
        self.ref_kf = kf_max
        f.ref_keyframe = kf_max
        # Deduped union of the local KFs' points, cached across frames: it
        # only changes when a member KF's slots change (tracked by
        # _mp_version; MapPoint.set_bad/replace bump it too, so bad points
        # never linger).  Consecutive frames usually share the local map
        # and no mapping ran in between, so most frames hit the cache.
        key = [(kf.id, kf._mp_version) for kf in self.local_kfs]
        if key != self._local_map_key:
            self._local_map_key = key
            self.local_mps = list(dict.fromkeys(
                mp
                for kf in self.local_kfs
                for mp in kf.get_valid_map_points()
            ))
            self._local_slots = None

    def _search_local_points(self, th: float | None = None):
        f = self.current
        fid = f.id
        table = self.atlas.get_current_map().landmarks
        # drop bad, bump n_visible/last_frame_seen, and stamp table slots
        # "already matched this frame" for the gather (C-speed object pass)
        hostops.mark_seen(f.map_points, table, fid, table.seen_stamp)
        if not self.local_mps:
            return
        # Batched frustum pass (Frame::isInFrustum semantics) over the
        # landmark table: one fancy-index per attribute instead of np.stack
        # over per-object attributes (which dominated TrackLocalMap).
        mps = self.local_mps
        if (
            self._local_slots is None
            or self._local_slots_table is not table
            or len(self._local_slots) != len(mps)
        ):
            self._local_slots = table.slots_of(mps)
            self._local_slots_table = table
        slots = self._local_slots
        sl = np.maximum(slots, 0)
        cand_mask = (slots >= 0) & table.valid[sl] & (table.seen_stamp[sl] != fid)
        ci = np.nonzero(cand_mask)[0]
        if len(ci) == 0:
            return
        s = slots[ci]
        pw = table.pos[s]
        normal = table.normal[s]
        min_d = table.min_d[s]
        max_d = table.max_d[s]
        pc = pw @ f.Tcw.R.T + f.Tcw.t
        ow = f.camera_center()
        v = pw - ow
        dist = np.linalg.norm(v, axis=1)
        uv = f.camera.project(np.where(pc[:, 2:3] > 1e-9, pc, [0, 0, 1.0]))
        view_cos = (v * normal).sum(1) / np.maximum(dist, 1e-9)
        ok = (
            (pc[:, 2] >= 0.1)
            & (f.min_x < uv[:, 0]) & (uv[:, 0] < f.max_x)
            & (f.min_y < uv[:, 1]) & (uv[:, 1] < f.max_y)
            & (min_d <= dist) & (dist <= max_d)
            & (view_cos >= 0.5)
        )
        oki = np.nonzero(ok)[0]
        if len(oki) == 0:
            return
        ratio = max_d[oki] / np.maximum(dist[oki], 1e-9)
        level = np.clip(
            np.ceil(np.log(np.maximum(ratio, 1e-12)) / f.log_scale_factor),
            0, f.n_levels - 1,
        )
        ur = uv[oki, 0] - f.mbf / np.maximum(pc[oki, 2], 1e-9) if f.mbf > 0 \
            else np.full(len(oki), -1.0)
        proj = np.column_stack(
            [uv[oki, 0], uv[oki, 1], ur, level, view_cos[oki]]
        ).astype(np.float32)
        cands = [mps[j] for j in ci[oki]]
        for mp in cands:
            mp.increase_visible()
        so = s[oki]
        if th is None:
            th = 3 if fid < self.last_reloc_frame_id + 2 else 1
        # large local maps ride the device batch matcher (one masked MXU
        # Hamming matmul); small ones stay on host where per-dispatch
        # latency would dominate (crossover measured by bench_matchers.py)
        if len(cands) >= matchers.DEVICE_MATCH_MIN:
            matchers.search_by_projection_cands_device(
                f, cands, proj, table.desc[so], th, device=self.device
            )
        else:
            matchers.search_by_projection_cands(
                f, cands, proj, table.n_obs[so], table.desc[so], th
            )
        import os

        if (
            f.camera2 is not None
            and os.environ.get("ORBSLAM3_TPU_DUAL_LP", "1") == "1"
        ):
            # right-camera frustum + projection search over the same
            # candidate set (the reference's mbTrackInViewR /
            # isInFrustumChecks(..., bRight) second pass); matches land at
            # global slots >= n_left through the right-view pseudo-frame
            trw = (f.Trl * f.Tcw).normalized()
            pc_r = pw @ trw.R.T + trw.t
            ow_r = trw.inverse().t
            v_r = pw - ow_r
            dist_r = np.linalg.norm(v_r, axis=1)
            uv_r = f.camera2.project(
                np.where(pc_r[:, 2:3] > 1e-9, pc_r, [0, 0, 1.0])
            )
            view_cos_r = (v_r * normal).sum(1) / np.maximum(dist_r, 1e-9)
            ok_r = (
                (pc_r[:, 2] >= 0.1)
                & (f.min_x < uv_r[:, 0]) & (uv_r[:, 0] < f.max_x)
                & (f.min_y < uv_r[:, 1]) & (uv_r[:, 1] < f.max_y)
                & (min_d <= dist_r) & (dist_r <= max_d)
                & (view_cos_r >= 0.5)
            )
            oki_r = np.nonzero(ok_r)[0]
            if len(oki_r):
                ratio_r = max_d[oki_r] / np.maximum(dist_r[oki_r], 1e-9)
                level_r = np.clip(
                    np.ceil(np.log(np.maximum(ratio_r, 1e-12)) / f.log_scale_factor),
                    0, f.n_levels - 1,
                )
                proj_r = np.column_stack(
                    [uv_r[oki_r, 0], uv_r[oki_r, 1], np.full(len(oki_r), -1.0),
                     level_r, view_cos_r[oki_r]]
                ).astype(np.float32)
                cands_r = [mps[j] for j in ci[oki_r]]
                # IncreaseVisible once per frame: only for points the left
                # frustum pass didn't already count
                for j in np.nonzero(ok_r & ~ok)[0]:
                    mps[ci[j]].increase_visible()
                so_r = s[oki_r]
                matchers.search_by_projection_cands(
                    f.right_view(), cands_r, proj_r,
                    table.n_obs[so_r], table.desc[so_r], th,
                )

    # --- inertial bookkeeping ---------------------------------------------
    def current_bias(self):
        """Best current bias estimate (for preintegrating incoming samples)."""
        from orbslam3_tpu_torch.imu.preintegration import Bias

        f = self.last_frame
        if f is not None and getattr(f, "imu_bias", None) is not None:
            return f.imu_bias.copy()
        if self.last_kf is not None and getattr(self.last_kf, "imu_bias", None) is not None:
            return self.last_kf.imu_bias.copy()
        return Bias()

    def _attach_imu_to_kf(self, kf):
        """Link the temporal KF chain and hand over the accumulated
        preintegration since the previous keyframe (Tracking::
        CreateNewKeyFrame sets mpImuPreintegratedFromLastKF / mPrevKF)."""
        if self.imu_calib is None:
            return
        from orbslam3_tpu_torch.imu.preintegration import Preintegrated

        prev = self.last_kf
        kf.prev_kf = prev
        if prev is not None:
            prev.next_kf = kf
            kf.imu_bias = prev.imu_bias.copy()
            if self._imu_meas_since_kf:
                pre = Preintegrated(prev.imu_bias, self.imu_calib)
                for a, w, dt in self._imu_meas_since_kf:
                    pre.integrate(a, w, dt)
                kf.imu_preint = pre
        f = self.current
        if getattr(f, "velocity", None) is not None:
            kf.velocity = f.velocity.copy()
        elif getattr(self, "_v_w", None) is not None:
            kf.velocity = self._v_w.copy()
        self._imu_meas_since_kf = []

    def update_frame_imu(self, T: SE3, scale: float, bias, kf):
        """Re-anchor the tracker's live frames after the map was re-leveled/
        re-scaled by IMU initialization (Tracking::UpdateFrameIMU role):
        the map moved under the tracker mid-frame, so the current/last frame
        poses, velocities, and logged relative poses must follow."""
        for f in (self.current, self.last_frame):
            if f is None:
                continue
            if f.Tcw is not None:
                twc = f.Tcw.inverse()
                f.set_pose(SE3(T.R @ twc.R, scale * (T.R @ twc.t) + T.t).inverse())
            f.imu_bias = bias.copy()
            if getattr(f, "velocity", None) is not None:
                f.velocity = scale * (T.R @ f.velocity)
        if getattr(self, "_v_w", None) is not None:
            self._v_w = scale * (T.R @ self._v_w)
        # stored relative poses: rotation-invariant, translation scales
        if scale != 1.0:
            self.trajectory = [
                (fid, ts, SE3(tcr.R, tcr.t * scale), ref, lost)
                for (fid, ts, tcr, ref, lost) in self.trajectory
            ]
        # constant-velocity model is stale across the re-anchoring, and so
        # is the marginalized VI prior's linearization point
        self.velocity = None
        self._imu_prior = None

    def _refine_pose_inertial(self):
        """Fuse the IMU preintegration into the frame pose once the map is
        VI-initialized (PoseInertialOptimizationLastFrame role in
        TrackLocalMap, Tracking4.cc:273 + Optimizer6.cc:432)."""
        f = self.current
        m = self.atlas.get_current_map()
        pre = getattr(f, "imu_preint", None)
        lf = self.last_frame
        if (
            self.imu_calib is None
            or not getattr(m, "imu_initialized", False)
            or pre is None
            or lf is None
            or lf.Tcw is None
        ):
            return
        lv = getattr(lf, "velocity", None)
        lb = getattr(lf, "imu_bias", None)
        if lv is None and self.last_kf is not None and self.last_kf.velocity is not None:
            lv, lb = self.last_kf.velocity, self.last_kf.imu_bias
        if lv is None:
            return
        from orbslam3_tpu_torch.imu.preintegration import Bias
        from orbslam3_tpu_torch.optim.inertial import (
            VIState,
            pose_inertial_optimization,
            pose_inertial_optimization_prior,
        )

        if lb is None:
            lb = Bias()
        Tbc = self.imu_calib.Tbc
        Tcb = Tbc.inverse()
        prev = VIState((Tbc * lf.Tcw).inverse().normalized(), np.asarray(lv, float), lb.copy())
        cur = VIState((Tbc * f.Tcw).inverse().normalized(),
                      np.asarray(lv, float), lb.copy())
        idx = [
            i
            for i in range(f.n)
            if f.map_points[i] is not None
            and not f.map_points[i].bad
            and not f.outlier[i]
            and f.map_points[i].n_obs > 0
        ]
        if len(idx) < 10:
            return
        idx = np.asarray(idx)
        obs = dict(
            obs_pw=np.stack([f.map_points[i].position for i in idx]),
            obs_uv=f.kps_un[idx],
            obs_ur=f.u_right[idx],
            inv_sigma2=f.inv_level_sigma2[f.octave[idx]],
            camera=f.camera,
            mbf=f.mbf,
            Tcb=Tcb,
            # fisheye right-camera rows (the reference's EdgeMono on the
            # rig's second camera — VertexPose holds both cameras)
            is_right=(idx >= f.n_left) if f.camera2 is not None else None,
            camera2=f.camera2,
            Trl=f.Trl,
        )
        # Marginalized-prior chain (PoseInertialOptimizationLastKeyFrame /
        # LastFrame + Marginalize): when the previous frame spawned a
        # keyframe its state was just re-estimated by mapping — hold it
        # fixed and restart the chain; otherwise optimize prev jointly,
        # bound by the prior carried from its own optimization, and
        # marginalize it out for the next frame.
        prior = getattr(self, "_imu_prior", None)
        prev_is_kf = lf.id == self.last_kf_frame_id
        if prev_is_kf or prior is None:
            out, _, next_prior = pose_inertial_optimization_prior(
                cur, prev, pre, prev_fixed=True, **obs
            )
        else:
            out, _, next_prior = pose_inertial_optimization_prior(
                cur, prev, pre, prior=prior, prev_fixed=False, **obs
            )
        self._imu_prior = next_prior
        f.set_pose(Tcb * out.Twb.inverse())
        f.velocity = out.v.copy()
        f.imu_bias = out.bias.copy()

    # --- keyframe policy ---------------------------------------------------
    def _need_new_keyframe(self) -> bool:
        if self.only_tracking:
            return False
        f = self.current
        m = self.atlas.get_current_map()
        n_kfs = m.n_keyframes()
        if f.id < self.last_reloc_frame_id + self.max_frames and n_kfs > self.max_frames:
            return False
        min_obs = 3 if n_kfs > 2 else 2
        ref_matches = self.ref_kf.tracked_map_points(min_obs) if self.ref_kf else 0
        # stereo close-point stats
        n_tracked_close = n_nontracked_close = 0
        if self.mbf > 0:
            close = (f.depth > 0) & (f.depth < self.depth_th)
            tracked = (f.map_points != None) & ~f.outlier  # noqa: E711 — elementwise
            n_tracked_close = int((close & tracked).sum())
            n_nontracked_close = int((close & ~tracked).sum())
        # Reference: tracked-close < 100 AND untracked-close > 70
        # (Tracking4.cc:459 region).  Added ratio form: when untracked close
        # structure outnumbers tracked close structure the camera is looking
        # at unmapped territory even if the absolute count is still "enough"
        # — insert before accuracy decays (absolute-100 assumes EuRoC-like
        # point budgets).
        need_insert_close = (
            n_tracked_close < 100 or n_nontracked_close > n_tracked_close
        ) and n_nontracked_close > 70
        th_ref = 0.75 if n_kfs < 2 else (0.9 if self.mbf <= 0 else 0.75)
        idle = self.local_mapper.accept_keyframes()
        c1a = f.id >= self.last_kf_frame_id + self.max_frames
        c1b = f.id >= self.last_kf_frame_id + self.min_frames and idle
        c1c = self.mbf > 0 and (
            self.matches_inliers < ref_matches * 0.25 or need_insert_close
        )
        c2 = (
            self.matches_inliers < ref_matches * th_ref or need_insert_close
        ) and self.matches_inliers > 15
        if not ((c1a or c1b or c1c) and c2):
            return False
        # Busy-mapper policy (Tracking4.cc:500 region): an idle mapper takes
        # the KF now; a busy one gets its running local BA interrupted
        # (InterruptBA -> mbAbortBA) and — stereo only — the KF still
        # inserts while the queue is short; monocular waits.
        self.n_kf_wanted += 1
        if idle:
            return True
        self.local_mapper.interrupt_ba()
        if self.mbf > 0:
            return self.local_mapper.queue_size() < 3
        return False

    def _create_new_keyframe(self):
        f = self.current
        m = self.atlas.get_current_map()
        kf = KeyFrame(f, m)
        self.ref_kf = kf
        f.ref_keyframe = kf
        if self.mbf > 0:
            # create close-depth map points not yet tracked (Tracking4.cc:540)
            z = f.depth
            cand = np.nonzero(z > 0)[0]
            order = cand[np.argsort(z[cand])]
            n_new = 0
            fresh = []
            for i in order:
                mp = f.map_points[i]
                if mp is None or mp.n_obs < 1:
                    pw = kf.unproject_stereo(i)
                    if pw is None:
                        continue
                    mp_new = MapPoint(pw, kf, m)
                    mp_new.add_observation(kf, i)
                    kf.add_map_point(mp_new, i)
                    f.map_points[i] = mp_new
                    j = self._right_slot_of(f, i)
                    if j >= 0:  # fisheye dual observation
                        mp_new.add_observation(kf, j)
                        kf.add_map_point(mp_new, j)
                        f.map_points[j] = mp_new
                    m.add_map_point(mp_new)
                    fresh.append(mp_new)
                    n_new += 1
                if z[i] > self.depth_th and n_new > 100:
                    break
            refresh_points(fresh)
        self._attach_imu_to_kf(kf)
        self.local_mapper.insert_keyframe(kf)
        self.last_kf = kf
        self.last_kf_frame_id = f.id

    def _clean_vo_matches(self):
        f = self.current
        hostops.clean_vo(f.map_points, f.outlier)

    # --- failure handling --------------------------------------------------
    def _predict_with_imu(self, frame) -> bool:
        """Dead-reckon the pose across the frame's preintegration window."""
        pre = getattr(frame, "imu_preint", None)
        if pre is None or self.last_frame is None or self.last_frame.Tcw is None:
            return False
        v = getattr(self.last_frame, "velocity", None)
        if v is None:
            v = getattr(self, "_v_w", None)
        if v is None:
            return False
        Tbc = self.imu_calib.Tbc if self.imu_calib is not None else SE3()
        twb = (Tbc * self.last_frame.Tcw).inverse()
        T_new, v_new = pre.predict_state(twb, np.asarray(v, float), self.current_bias())
        frame.set_pose(Tbc.inverse() * T_new.inverse())
        frame.velocity = v_new.copy()
        self._v_w = v_new
        return True

    def _reacquire_at_prediction(self) -> bool:
        """Try to re-match the local map at the (IMU-predicted) pose."""
        f = self.current
        f.map_points[:] = None
        self._search_local_points(th=5)
        n_in = self._optimize_current_pose(map_only=True)
        if n_in >= 30:
            self.matches_inliers = n_in
            self.state = TrackingState.OK
            return True
        # keep the dead-reckoned pose as output; stay RECENTLY_LOST
        return False

    def _update_velocity_estimate(self, frame):
        """World-frame velocity from consecutive frame poses (for IMU
        prediction before full VI initialization provides one)."""
        lf = self.last_frame
        if lf is None or lf.Tcw is None or frame.Tcw is None:
            return
        dt = frame.timestamp - lf.timestamp
        if dt <= 0:
            return
        self._v_w = (frame.Tcw.inverse().t - lf.Tcw.inverse().t) / dt

    def _relocalize(self) -> bool:
        if self.relocalizer is None:
            return False
        ok = self.relocalizer(self.current)
        if ok:
            self.last_reloc_frame_id = self.current.id
            self.state = TrackingState.OK
            self._imu_prior = None
        return ok

    def _fork_map(self):
        """CreateMapInAtlas role: fresh map, full tracker state reset."""
        self.atlas.create_new_map()
        self._fork_map_state_only()

    def _reset_active_map(self):
        """System::ResetActiveMap role: clear the current map's contents and
        restart initialization in place (used on inertial timestamp jumps
        before the map is fully VI-refined)."""
        from orbslam3_tpu_torch.slam.map import LandmarkTable

        m = self.atlas.get_current_map()
        for kf in m.get_all_keyframes():
            kf.bad = True
        for mp in m.get_all_map_points():
            mp.bad = True
            mp._table = None
            mp._slot = -1
        m.keyframes.clear()
        m.map_points.clear()
        m.landmarks = LandmarkTable()
        m.imu_initialized = False
        self._fork_map_state_only()

    def _fork_map_state_only(self):
        self.state = TrackingState.NOT_INITIALIZED
        self.temporal_points.clear()
        self.velocity = None
        self.ref_kf = None
        self.last_kf = None
        self.last_frame = None
        self._imu_meas_since_kf = []
        self._ini_frame = None
        self._imu_prior = None

    def _handle_lost(self):
        """Atlas elastic recovery: fork a fresh map (Tracking3.cc:263-281)."""
        m = self.atlas.get_current_map()
        if m.n_keyframes() > 10:
            self.atlas.create_new_map()
        self.state = TrackingState.NOT_INITIALIZED
        self.velocity = None
        self.ref_kf = None
        # The inertial temporal chain must not cross the map boundary: the
        # reference resets mpImuPreintegratedFromLastKF / mnLastKeyFrameId on
        # CreateMapInAtlas (Tracking3.cc:911 region).  Without this, the new
        # map's first KF would get prev_kf in the OLD map plus a
        # preintegration spanning the whole lost gap, corrupting VI init and
        # inertial BA of the fresh map.
        self.last_kf = None
        self._imu_meas_since_kf = []
        self._ini_frame = None
        self._imu_prior = None
