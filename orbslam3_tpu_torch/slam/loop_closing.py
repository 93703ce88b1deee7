"""Loop closing: place recognition, Sim3 verification, loop correction.

Role-parity with ORB_SLAM3/src/LoopClosing1-3.cc (2,607 LoC):
NewDetectCommonRegions (BoW candidates -> geometric verification via Sim3
RANSAC, LoopClosing1.cc:324,578), CorrectLoop (pose propagation through the
covisible group, map-point transport, fuse, loop edges, essential-graph
optimization, LoopClosing2.cc:106), a global-BA pass
(RunGlobalBundleAdjustment, LoopClosing3.cc:520; synchronous here in
sequential mode, worker thread otherwise), and map-merge across Atlas maps
(`merge_maps`, incl. the inertial 4-DoF weld — MergeLocal/MergeLocal2
role, LoopClosing2.cc:352 / LoopClosing3.cc:35).
"""

from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np

from orbslam3_tpu_torch.optim.essential_graph import optimize_essential_graph
from orbslam3_tpu_torch.optim.sim3_solver import sim3_ransac
from orbslam3_tpu_torch.slam import matchers
from orbslam3_tpu_torch.utils.benchmark import trace_range
from orbslam3_tpu_torch.utils.lie import Sim3


class LoopClosing:
    def __init__(self, atlas, kf_database, fix_scale: bool = True,
                 run_gba: bool = True, imu_calib=None):
        self.atlas = atlas
        self.db = kf_database
        self.fix_scale = fix_scale
        self.run_gba = run_gba
        self.imu_calib = imu_calib
        self.last_loop_kf_id = -1
        self.n_loops_closed = 0
        # threaded mode (LoopClosing::Run, src/LoopClosing1.cc:90): a KF
        # queue drained by spin() on a worker thread; sequential mode
        # processes inline for determinism
        self.sequential = True
        self.kf_queue: queue.Queue = queue.Queue()
        # sequential mode: keyframes the tracker's frame made, handled once
        # the frame is logged (run_held)
        self.held: list = []
        self.finished = False
        # LocalMapping handle for the pause handshake around corrections
        # (reference member mpLocalMapper; set by System)
        self.local_mapper = None
        # --- place-recognition verification parameters (the reference's
        # thresholds at LoopClosing1.cc:578 DetectCommonRegionsFromBoW:
        # nBoWMatches=20, nBoWInliers=15, nSim3Inliers=20, nProjMatches=50,
        # nProjOptMatches=80, scaled to this front-end's ~1k-feature budget)
        self.th_bow = 20           # BoW matches to attempt geometric check
        self.th_ransac = 15        # Sim3-RANSAC inliers
        self.th_proj = 30          # guided Scw projection matches
        self.th_opt = 25           # OptimizeSim3 inliers
        self.th_proj_view = 25     # per-view matches for a coincidence vote
        # geometric verifications (distinct camera views agreeing on the
        # candidate region) required before a correction fires — the
        # reference's mnLoopNumCoincidences >= 3 (LoopClosing1.cc:324-578).
        # Votes come from the current KF, its covisible KFs (spatial), and
        # subsequent KFs (temporal carry-over via _pending).
        self.n_consistency = 3
        self._pending = None       # partially verified candidate state

    # ------------------------------------------------------------------
    def insert_keyframe(self, kf):
        if kf.id == 0:
            return
        if self.sequential:
            # held until the tracker has logged the frame that made it, as
            # upstream's Track() records the frame before its LoopClosing
            # thread takes the keyframe: a merge or a correction moves the
            # frame's reference keyframe, and the frame's pose, still in
            # the old coordinates, would be logged against the moved one
            self.held.append(kf)
        else:
            self.kf_queue.put(kf)

    def run_held(self):
        """Sequential mode: handle the held keyframes, in order."""
        while self.held:
            self._handle(self.held.pop(0))

    def spin(self):
        """Worker-thread loop (LoopClosing::Run role)."""
        while not self.finished:
            try:
                kf = self.kf_queue.get(timeout=0.05)
            except queue.Empty:
                continue
            self._handle(kf)

    def request_finish(self):
        # flag only: the spin thread may be mid-_handle and could still
        # spawn work; System.shutdown joins the spin thread FIRST, then
        # calls join_gba() (the finished flag also downgrades any GBA
        # requested after this point to inline execution)
        self.finished = True

    def join_gba(self):
        """Join an in-flight transient GBA so it writes back before
        shutdown persistence reads the map."""
        t = getattr(self, "_gba_thread", None)
        if t is not None and t.is_alive():
            t.join()

    def _handle(self, kf):
        with trace_range("LC.keyframe", frame=kf.frame_id):
            result = self.detect_loop(kf)
            if result is not None:
                cand, s_cur_cand, matches = result
                # pause LocalMapping first (reference: RequestStop + isStopped
                # wait before CorrectLoop/MergeLocal) so loop correction cannot
                # race with concurrent triangulation/fusion on the same map,
                # then take the map-update lock to exclude a concurrent Track()
                # (mMutexMapUpdate role, Tracking3.cc:135)
                # abort any in-flight transient GBA FIRST (reference CorrectLoop
                # order: mbStopGBA before RequestStop) — joining it after taking
                # the mapper pause lock would deadlock against the GBA thread's
                # own request_stop()
                self._abort_running_gba()
                mapper = self.local_mapper
                if mapper is not None:
                    mapper.request_stop()
                # a merge holds both maps' update locks until the welding BA
                # ends (LoopClosing::MergeLocal locks the current and the
                # merged map): once change_map has run, a frame tracks on the
                # old map, and LocalMapping writes its BA back to it.  One
                # order, by map id, and no other thread holds two of them
                maps = sorted({kf.map, cand.map}, key=lambda m: m.id)
                try:
                    with contextlib.ExitStack() as held:
                        for m in maps:
                            held.enter_context(m.update_lock)
                        # keyframes the tracker queued for the mapper join the
                        # current map first, so the correction or the merge
                        # moves them with the rest (LocalMapping::EmptyQueue:
                        # ProcessNewKeyFrame on each)
                        while mapper is not None and not mapper.kf_queue.empty():
                            mapper._process_new_keyframe(mapper._dequeued(mapper.kf_queue.get_nowait()))
                        if cand.map is kf.map:
                            with trace_range("LC.correct"):
                                self.correct_loop(kf, cand, s_cur_cand, matches)
                        else:
                            with trace_range("LC.merge"):
                                self.merge_maps(kf, cand, s_cur_cand)
                finally:
                    if mapper is not None:
                        mapper.resume()

    # ------------------------------------------------------------------
    def detect_loop(self, kf, min_matches: int = 20):
        """Place recognition with the reference's full verification ladder
        (NewDetectCommonRegions + DetectCommonRegionsFromBoW,
        ORB_SLAM3/src/LoopClosing1.cc:324-578):

          BoW candidates -> SearchByBoW -> Sim3 RANSAC -> guided Scw
          SearchByProjection over the candidate's covisible window ->
          OptimizeSim3 (inlier reclassification) -> coincidence votes from
          the current KF + its covisible views (spatial) + subsequent KFs
          (temporal, via DetectAndReffineSim3FromLastKF-style carry-over),
          firing only at n_consistency agreeing views.

        Returns (loop_kf, Sim3 cur<-cand, {cur_idx: loop MapPoint}) or None.
        """
        m = self.atlas.get_current_map()
        # same-map loops need a mature map; cross-map merges only need the
        # fresh map to have a few keyframes
        min_kfs = 12 if self.atlas.count_maps() == 1 else 3
        if m.n_keyframes() < min_kfs or kf.id < self.last_loop_kf_id + 10:
            return None
        if kf.bow_vec is None:
            return None

        # continuation of a partially verified candidate from earlier KFs
        if self._pending is not None:
            fired = self._try_pending(kf)
            if fired is not None:
                return fired
            if self._pending is not None:
                return None  # still accumulating coincidences

        candidates = self.db.detect_n_best_candidates(kf, 3)
        for cand in candidates:
            if cand.bad or getattr(cand.map, "bad", False):
                continue
            # temporal gate (same-map loops): candidate must be old;
            # cross-map candidates (merge) have no such constraint
            if cand.map is m and abs(cand.id - kf.id) < 10:
                continue
            matches, n = matchers.search_by_bow(cand, kf, ratio=0.75)
            if n < max(self.th_bow, min_matches):
                continue
            idx = sorted(matches.keys())
            own = [kf.map_points[i] for i in idx]
            keep = [
                k
                for k, i in enumerate(idx)
                if own[k] is not None and not own[k].bad and not matches[i].bad
            ]
            if len(keep) < max(self.th_ransac, min_matches):
                continue
            idx = [idx[k] for k in keep]
            p_cur = np.stack([kf.Tcw * kf.map_points[i].position for i in idx])
            p_cand = np.stack([cand.Tcw * matches[i].position for i in idx])
            s2_cur = np.asarray([kf.level_sigma2[kf.octave[i]] for i in idx])
            s2_cand = s2_cur  # same pyramid parameters
            s12, inl = sim3_ransac(
                p_cur, p_cand, kf.camera, cand.camera, s2_cur, s2_cand,
                self.fix_scale, min_inliers=max(self.th_ransac, min_matches),
            )
            if s12 is None:
                continue
            good = {idx[k]: matches[idx[k]] for k in range(len(idx)) if inl[k]}

            # --- refinement ladder ---------------------------------------
            window = self._candidate_window_points(cand)
            from orbslam3_tpu_torch.utils.lie import Sim3

            scw = (s12 * Sim3.from_se3(cand.Tcw)).normalized()
            proj = matchers.search_by_projection_scw(
                kf, scw, window, matched=good, th=8.0
            )
            if len(proj) < self.th_proj:
                continue
            from orbslam3_tpu_torch.optim.sim3_optimizer import optimize_sim3_pairs

            s12_ref, surviving, n_in = optimize_sim3_pairs(
                kf, cand, proj, s12, fix_scale=self.fix_scale
            )
            if n_in < self.th_opt:
                continue
            scw = (s12_ref * Sim3.from_se3(cand.Tcw)).normalized()
            # stricter second projection pass at the refined pose
            proj2 = matchers.search_by_projection_scw(kf, scw, window, th=5.0)
            if len(proj2) < self.th_proj:
                continue

            # --- coincidence votes: current view + covisible views -------
            votes = 1 + self._spatial_coincidences(kf, scw, window)
            if votes >= self.n_consistency:
                return cand, s12_ref, proj2
            # carry to subsequent keyframes (temporal consistency)
            self._pending = dict(
                cand=cand, scw=scw, window=window, votes=votes,
                last_kf=kf, fails=0,
            )
            return None
        return None

    def _candidate_window_points(self, cand, n_covisibles: int = 10):
        """Map points of the candidate + its best covisibles (the
        reference's nNumCovisibles=5..10 window, LoopClosing1.cc:578+)."""
        kfs = [cand] + [
            k for k in cand.get_best_covisibility_keyframes(n_covisibles)
            if not k.bad
        ]
        seen = set()
        out = []
        for k in kfs:
            for _, mp in k.get_map_point_indices():
                if mp.id not in seen:
                    seen.add(mp.id)
                    out.append(mp)
        return out

    def _spatial_coincidences(self, kf, scw, window):
        """Votes from the current KF's covisible views: each covisible KF
        re-projects the candidate window through its own propagated Scw and
        votes if enough matches land (the reference's
        vpCurrentCovKFs verification loop in DetectCommonRegionsFromBoW)."""
        from orbslam3_tpu_torch.utils.lie import Sim3

        votes = 0
        for cov in kf.get_best_covisibility_keyframes(5):
            if cov.bad:
                continue
            s_cov_kf = Sim3.from_se3((cov.Tcw * kf.Twc).normalized())
            scw_cov = (s_cov_kf * scw).normalized()
            matched = matchers.search_by_projection_scw(
                cov, scw_cov, window, th=8.0
            )
            if len(matched) >= self.th_proj_view:
                votes += 1
            if votes >= self.n_consistency - 1:
                break
        return votes

    def _try_pending(self, kf):
        """Re-verify the pending candidate from this new keyframe
        (DetectAndReffineSim3FromLastKF role, LoopClosing1.cc:535): predict
        Scw by composing the odometry since the last verifying KF, re-match,
        re-optimize; a success adds a coincidence vote, two consecutive
        failures cancel the candidate."""
        from orbslam3_tpu_torch.optim.sim3_optimizer import optimize_sim3_pairs
        from orbslam3_tpu_torch.utils.lie import Sim3

        p = self._pending
        cand = p["cand"]
        if cand.bad or kf.bow_vec is None or kf.map is not p["last_kf"].map:
            self._pending = None
            return None
        s_cl = Sim3.from_se3((kf.Tcw * p["last_kf"].Twc).normalized())
        scw = (s_cl * p["scw"]).normalized()
        matched = matchers.search_by_projection_scw(kf, scw, p["window"], th=8.0)
        ok = False
        if len(matched) >= self.th_proj_view:
            s12 = (scw * Sim3.from_se3(cand.Tcw).inverse()).normalized()
            s12_ref, surviving, n_in = optimize_sim3_pairs(
                kf, cand, matched, s12, fix_scale=self.fix_scale
            )
            if n_in >= self.th_opt:
                ok = True
                p["votes"] += 1
                p["last_kf"] = kf
                p["scw"] = (s12_ref * Sim3.from_se3(cand.Tcw)).normalized()
                if p["votes"] >= self.n_consistency:
                    self._pending = None
                    return cand, s12_ref, surviving
        if not ok:
            p["fails"] += 1
            if p["fails"] >= 2:
                self._pending = None
        return None

    # ------------------------------------------------------------------
    def correct_loop(self, kf, loop_kf, s_cur_cand: Sim3, matches: dict):
        """Propagate the Sim3 correction through kf's covisible group,
        transport their map points, fuse loop duplicates, add the loop edge,
        and optimize the essential graph (CorrectLoop semantics)."""
        m = self.atlas.get_current_map()
        # corrected Sim3 of the current KF: Scw = S_cur_cand * S_cand_w
        s_cand_w = Sim3.from_se3(loop_kf.Tcw)
        s_cur_w_corr = s_cur_cand * s_cand_w
        s_cur_w_old = Sim3.from_se3(kf.Tcw)

        # the loop KF is the anchor: never drag it (in real loops it is not
        # covisible with the current KF, but small/fully-connected maps can
        # put it in the group)
        group = [kf] + [
            k
            for k in kf.get_best_covisibility_keyframes(1000)
            if not k.bad and k is not loop_kf
        ]
        corrected: dict = {}
        non_corrected: dict = {}
        for k in group:
            s_k_old = Sim3.from_se3(k.Tcw)
            non_corrected[k] = s_k_old
            s_rel = s_k_old * s_cur_w_old.inverse()
            corrected[k] = (s_rel * s_cur_w_corr).normalized()

        # transport map points of the group (P' = S_corr^-1 (S_old (P))),
        # remembering which group KF moved each point (mnCorrectedReference
        # role) so the post-optimization pass can re-anchor to the same KF
        moved: dict = {}
        for k in group:
            s_old = non_corrected[k]
            s_new = corrected[k]
            for _, mp in k.get_map_point_indices():
                if mp.id in moved:
                    continue
                moved[mp.id] = k
                mp.position = s_new.inverse().apply(
                    s_old.apply(mp.position[None])
                )[0]
                mp.update_normal_and_depth()
            k.corrected_sim3 = s_new
            k.set_pose(s_new.to_se3())
            k.update_connections()

        # fuse loop-candidate points into the current KF (SearchAndFuse).
        # The matches were found while LocalMapping still ran: a loop point
        # culled since is dropped, one fused into another since is followed
        # to the point that replaced it
        matches = {i: mp.get_replaced() for i, mp in matches.items()}
        matches = {i: mp for i, mp in matches.items() if not mp.bad}
        for i, mp_loop in matches.items():
            cur_mp = kf.map_points[i]
            if cur_mp is not None and cur_mp is not mp_loop and not cur_mp.bad:
                cur_mp.replace(mp_loop)
            elif cur_mp is None:
                kf.add_map_point(mp_loop, i)
                mp_loop.add_observation(kf, i)
                mp_loop.compute_distinctive_descriptor()
        # loop-side window (loop KF + covisibles, mvpLoopMapPoints) fused
        # into each corrected group KF through its CORRECTED Sim3 — keeps
        # the mono scale factor the SE3 pose drops (SearchAndFuse,
        # LoopClosing3.cc:367 via the Scw Fuse overload)
        loop_mps = self._candidate_window_points(loop_kf)
        for k in group:
            matchers.fuse_scw(k, corrected[k], loop_mps, th=4.0)

        # loop edges
        kf.loop_edges.add(loop_kf)
        loop_kf.loop_edges.add(kf)
        kf.update_connections()

        # essential graph over the whole map
        kfs = [k for k in m.get_all_keyframes() if not k.bad]
        edges = []
        seen_pairs = set()

        def add_edge(a, b, weight, use_corrected=False):
            key = (min(a.id, b.id), max(a.id, b.id))
            if key in seen_pairs or a is b:
                return
            seen_pairs.add(key)
            sa = non_corrected.get(a, Sim3.from_se3(a.Tcw) if a not in corrected else corrected[a])
            sb = non_corrected.get(b, Sim3.from_se3(b.Tcw) if b not in corrected else corrected[b])
            edges.append((a, b, (sb * sa.inverse()).normalized(), weight))

        for k in kfs:
            if k.parent is not None and not k.parent.bad:
                add_edge(k.parent, k, 100.0)
            for le in k.loop_edges:
                if not le.bad:
                    add_edge(le, k, 100.0)
            for nb in k.get_covisibles_by_weight(100):
                if not nb.bad:
                    add_edge(nb, k, 1.0)
        # the fresh loop constraint uses the VERIFIED relative Sim3
        key = (min(kf.id, loop_kf.id), max(kf.id, loop_kf.id))
        edges = [e for e in edges if (min(e[0].id, e[1].id), max(e[0].id, e[1].id)) != key]
        s_loop_w = Sim3.from_se3(loop_kf.Tcw)
        edges.append((loop_kf, kf, (s_cur_w_corr * s_loop_w.inverse()).normalized(), 100.0))

        for k in kfs:
            if k in corrected:
                k.corrected_sim3 = corrected[k]
        fixed = {loop_kf}
        inertial = getattr(m, "imu_initialized", False)
        # pre-optimization poses (the reference's vScw, Optimizer3.cc:48
        # region): group KFs use the CORRECTED Sim3 (keeps the mono scale
        # factor that to_se3 drops), others their current stale pose
        pre_opt = {k: corrected.get(k, Sim3.from_se3(k.Tcw)) for k in kfs}
        if inertial:
            # gravity-aligned map: 4-DoF graph (OptimizeEssentialGraph4DoF
            # role) keeps roll/pitch and scale exact
            from orbslam3_tpu_torch.optim.essential_graph import (
                optimize_essential_graph_4dof,
            )

            result = optimize_essential_graph_4dof(kfs, edges, fixed)
        else:
            result = optimize_essential_graph(
                kfs, edges, fixed, fix_scale=self.fix_scale
            )
        if inertial:
            # transport world-frame velocities by each KF's TOTAL correction
            # (original pre-loop pose -> optimized pose).  Group KFs' poses
            # were already moved during Sim3 propagation, so the original
            # must come from non_corrected, not from the post-propagation
            # snapshot (the reference rotates mVw by Rcor during
            # CorrectedSim3 propagation, LoopClosing2.cc:106 region).
            for k in kfs:
                v = getattr(k, "velocity", None)
                if v is None:
                    continue
                w_corr = result[k].inverse() * non_corrected.get(k, pre_opt[k])
                k.velocity = w_corr.s * (w_corr.R @ v)

        # post-pass: EVERY map point moves by its anchor keyframe's
        # (pre-optimization -> optimized) correction
        # (ORB_SLAM3/src/Optimizer3.cc:312-323).  Group-transported
        # points re-anchor to the KF that moved them (mnCorrectedReference);
        # everything else anchors to its reference keyframe, so points far
        # outside the covisible group still follow the essential graph even
        # when the optional global BA is skipped.
        for mp in m.get_all_map_points():
            if mp.bad:
                continue
            anchor = moved.get(mp.id)
            if anchor is None:
                anchor = mp.ref_kf
            if anchor is None or anchor not in result:
                continue
            s_pre = pre_opt.get(anchor)
            if s_pre is None:
                continue
            mp.position = result[anchor].inverse().apply(
                s_pre.apply(mp.position[None])
            )[0]
            mp.update_normal_and_depth()
        for k in kfs:
            if hasattr(k, "corrected_sim3"):
                del k.corrected_sim3

        self.last_loop_kf_id = kf.id
        self.n_loops_closed += 1
        m.info_changed()

        if self.run_gba:
            self._global_ba(m, kf)
        return True

    # ------------------------------------------------------------------
    def merge_maps(self, kf_cur, kf_match, s_cur_match: Sim3):
        """Weld the current (young) map into the matched keyframe's (old)
        map (LoopClosing::MergeLocal role, ORB_SLAM3/src/
        LoopClosing2.cc:352): transform every keyframe and map point of the
        current map by the verified Sim3 so kf_cur lands consistently in
        the old map's frame, move them over, fuse duplicates around the
        weld, reconnect the covisibility graph, run a welding local BA, and
        retire the young map.

        Inertial variant (MergeLocal2 role, ORB_SLAM3/src/
        LoopClosing3.cc:35): when either map is VI-initialized both maps are
        gravity-leveled and metric, so the alignment is constrained to
        4 DoF — scale forced to 1 and the rotation projected to pure yaw
        (rotation about gravity) — and keyframe velocities are transported
        with the rotation; the welding BA is the inertial one."""
        from orbslam3_tpu_torch.optim.local_ba import local_bundle_adjustment
        from orbslam3_tpu_torch.slam import matchers

        m_young = kf_cur.map
        m_old = kf_match.map
        inertial = getattr(m_young, "imu_initialized", False) or getattr(
            m_old, "imu_initialized", False
        )
        # alignment of the young map's world into the old map's world:
        # S_w'w = (S_cur_cand * S_cand_w')^-1 * S_cur_w
        s_cur_w_target = s_cur_match * Sim3.from_se3(kf_match.Tcw)
        s_align = (s_cur_w_target.inverse() * Sim3.from_se3(kf_cur.Tcw)).normalized()
        if inertial:
            # project to gravity-consistent 4 DoF: unit scale, yaw-only
            yaw = np.arctan2(s_align.R[1, 0], s_align.R[0, 0])
            cy, sy = np.cos(yaw), np.sin(yaw)
            r_yaw = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
            s_align = Sim3(1.0, r_yaw, s_align.t)

        young_kfs = m_young.get_all_keyframes()
        young_mps = m_young.get_all_map_points()
        for k in young_kfs:
            s_new = (Sim3.from_se3(k.Tcw) * s_align.inverse()).normalized()
            k.set_pose(s_new.to_se3())
            if getattr(k, "velocity", None) is not None:
                k.velocity = s_align.s * (s_align.R @ k.velocity)
            k.map = m_old
            m_old.add_keyframe(k)
        for mp in young_mps:
            mp.position = s_align.apply(mp.position[None])[0]
            mp.map = m_old
            mp.update_normal_and_depth()
            m_old.add_map_point(mp)

        # weld: fuse old-map points into the young neighborhood and back
        old_near = [mp for _, mp in kf_match.get_map_point_indices()]
        for nb in [kf_match] + kf_match.get_best_covisibility_keyframes(5):
            old_near += [mp for _, mp in nb.get_map_point_indices()]
        seen = set()
        old_near = [mp for mp in old_near if not (mp.id in seen or seen.add(mp.id))]
        for k in [kf_cur] + kf_cur.get_best_covisibility_keyframes(5):
            matchers.fuse(k, old_near, th=4.0)
        young_near = [mp for _, mp in kf_cur.get_map_point_indices()]
        for nb in [kf_match] + kf_match.get_best_covisibility_keyframes(5):
            matchers.fuse(nb, young_near, th=4.0)

        for k in young_kfs + [kf_match]:
            k.update_connections(parent_candidates=False)
        # root the young segment's spanning tree under the old map
        root = min(young_kfs, key=lambda k: k.id)
        if root.parent is None and root is not kf_match:
            root.parent = kf_match
            kf_match.children.add(root)

        kf_cur.merge_edges.add(kf_match)
        kf_match.merge_edges.add(kf_cur)
        self.atlas.change_map(m_old)
        self.atlas.set_map_bad(m_young)
        self.atlas.remove_bad_maps()
        if inertial:
            m_old.imu_initialized = True
            m_old.is_inertial = True
        # welding BA (MergeInertialBA role when VI-initialized)
        if inertial and self.imu_calib is not None and kf_cur.imu_preint is not None:
            from orbslam3_tpu_torch.optim.local_inertial_ba import local_inertial_ba

            local_inertial_ba(kf_cur, m_old, self.imu_calib, window=6)
        else:
            local_bundle_adjustment(kf_cur, m_old)
        self.last_loop_kf_id = kf_cur.id
        self.n_merges = getattr(self, "n_merges", 0) + 1
        m_old.info_changed()
        return True

    # ------------------------------------------------------------------
    def _global_ba(self, m, kf):
        """Full-map BA after a correction: visual (GlobalBundleAdjustemnt
        role) or, on VI-initialized maps with a known calib, the inertial
        variant (FullInertialBA role) — see optim/global_ba.py.

        Sequential mode runs inline (deterministic).  Threaded mode spawns
        the reference's TRANSIENT GBA thread (RunGlobalBundleAdjustment,
        ORB_SLAM3/src/LoopClosing3.cc:520): the solve runs outside the
        map lock while tracking/mapping continue; the write-back then takes
        the lock and reconciles keyframes/points created meanwhile via the
        spanning tree (apply_global_ba).  A newer correction aborts an
        in-flight GBA before it writes (mbStopGBA role)."""
        from orbslam3_tpu_torch.optim.global_ba import (
            apply_global_ba,
            full_inertial_ba,
            global_bundle_adjustment,
        )

        from orbslam3_tpu_torch.optim.bundle_adjustment import bundle_adjust
        from orbslam3_tpu_torch.optim.global_ba import build_global_ba

        inertial = getattr(m, "imu_initialized", False) and self.imu_calib is not None
        if self.sequential or self.finished:
            # inline (deterministic; also the shutdown path — never spawn a
            # thread that could outlive the join in System.shutdown)
            with trace_range("LC.global_ba", frame=kf.frame_id):
                if inertial:
                    full_inertial_ba(m, self.imu_calib)
                else:
                    global_bundle_adjustment(m)
            return

        self._abort_running_gba()
        self._gba_abort = False

        def paused_mapper():
            import contextlib

            @contextlib.contextmanager
            def cm():
                if self.local_mapper is not None:
                    self.local_mapper.request_stop()
                try:
                    yield
                finally:
                    if self.local_mapper is not None:
                        self.local_mapper.resume()

            return cm()

        def run():
            with trace_range("LC.global_ba", frame=kf.frame_id):
                if inertial:
                    # the inertial chain pass reads AND mutates the live graph:
                    # run it exclusively (off-thread, mapper paused + map lock —
                    # the mapper mutates observations outside the map lock)
                    with paused_mapper(), m.update_lock:
                        if not self._gba_abort and m in self.atlas.get_all_maps():
                            full_inertial_ba(m, self.imu_calib)
                    return
                # snapshot under the same exclusivity (build reads live
                # observation dicts), then solve WITHOUT any lock
                with paused_mapper(), m.update_lock:
                    built = build_global_ba(m)
                if built is None or self._gba_abort:
                    return
                kfs, mps, pr = built
                poses, points, _ = bundle_adjust(pr, n_iters=10)
                if self._gba_abort:
                    return
                with paused_mapper(), m.update_lock:
                    if not self._gba_abort and m in self.atlas.get_all_maps():
                        apply_global_ba(m, (kfs, poses, mps, points))

        self._gba_thread = threading.Thread(target=run, daemon=True)
        self._gba_thread.start()

    def _abort_running_gba(self):
        """Abort + join an in-flight transient GBA (mbStopGBA role)."""
        t = getattr(self, "_gba_thread", None)
        if t is not None and t.is_alive():
            self._gba_abort = True
            t.join()
