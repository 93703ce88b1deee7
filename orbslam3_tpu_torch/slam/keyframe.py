"""KeyFrame: a retained frame with covisibility + spanning-tree topology.

Role-parity with ORB_SLAM3/include/KeyFrame.h (544 LoC) /
src/KeyFrame.cc (1159 LoC): pose, shared feature arrays, per-index map-point
slots, the weighted covisibility graph (UpdateConnections /
GetBestCovisibilityKeyFrames / GetCovisiblesByWeight), spanning tree with
parent/children, loop/merge edges, redundancy stats for culling, and the
same grid/area queries as Frame (delegated to the source Frame arrays).
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.slam.frame import Frame, GRID_COLS, GRID_ROWS  # noqa: F401
from orbslam3_tpu_torch.utils.lie import SE3


class KeyFrame:
    _next_id = 0

    def __init__(self, frame: Frame, map_):
        self.id = KeyFrame._next_id
        KeyFrame._next_id += 1
        self.frame_id = frame.id
        self.timestamp = frame.timestamp
        self.map = map_

        # shared feature data (SoA, no copies)
        self.kps = frame.kps
        self.kps_un = frame.kps_un
        self.octave = frame.octave
        self.angle = frame.angle
        self.response = frame.response
        self.desc = frame.desc
        self.u_right = frame.u_right
        self.depth = frame.depth
        self.n = frame.n
        # fisheye dual-camera layout (NLeft/NRight, include/KeyFrame.h:508-529);
        # pinhole stereo keeps n_left == n (all kps are "left")
        self.n_left = getattr(frame, "n_left", frame.n)
        self.n_right = getattr(frame, "n_right", 0)
        self.Tlr = getattr(frame, "Tlr", None)
        self.Trl = getattr(frame, "Trl", None)
        self.left_to_right = getattr(frame, "left_to_right", None)
        self.right_to_left = getattr(frame, "right_to_left", None)
        self.stereo_p3d = getattr(frame, "stereo_p3d", None)
        self._right_view = None
        self.camera = frame.camera
        self.camera2 = getattr(frame, "camera2", None)
        self.mbf = frame.mbf
        self.mb = frame.mb
        self.scale_factors = frame.scale_factors
        self.level_sigma2 = frame.level_sigma2
        self.inv_level_sigma2 = frame.inv_level_sigma2
        self.n_levels = frame.n_levels
        self.log_scale_factor = frame.log_scale_factor
        self.min_x, self.max_x = frame.min_x, frame.max_x
        self.min_y, self.max_y = frame.min_y, frame.max_y
        self._frame = frame  # grid queries delegate to the frame

        self.Tcw = frame.Tcw.copy()
        self.map_points = frame.map_points.copy()
        # bumped on every map_points slot mutation (add/erase here, and the
        # direct writes in MapPoint.set_bad/replace); invalidates the
        # valid-point cache and the tracker's local-map union cache
        self._mp_version = 0
        self._mp_cache_ver = -1
        self._mp_cache: list = []

        # covisibility
        self.connected_weights: dict[KeyFrame, int] = {}
        self.ordered_kfs: list[KeyFrame] = []
        self.ordered_weights: list[int] = []
        # spanning tree
        self.parent: KeyFrame | None = None
        self.children: set[KeyFrame] = set()
        self.loop_edges: set[KeyFrame] = set()
        self.merge_edges: set[KeyFrame] = set()
        self.first_connection = True
        self.not_erase = False
        self.to_be_erased = False
        self.bad = False

        # BoW (inherited from the frame when a vocabulary is active)
        self.bow_vec = getattr(frame, "bow_vec", None)
        self.feat_vec = getattr(frame, "feat_vec", None)

        # visual-inertial state (KeyFrame::mVw/mImuBias/mpImuPreintegrated,
        # temporal chain mPrevKF/mNextKF — include/KeyFrame.h region)
        self.velocity = getattr(frame, "velocity", None)
        self.imu_bias = getattr(frame, "imu_bias", None)
        if self.imu_bias is None:
            from orbslam3_tpu_torch.imu.preintegration import Bias

            self.imu_bias = Bias()
        self.imu_preint = None  # preintegration prev_kf -> this (set by Tracking)
        self.prev_kf: KeyFrame | None = None
        self.next_kf: KeyFrame | None = None

        # bookkeeping used by LocalMapping/LoopClosing
        self.ba_local_for_kf = -1
        self.ba_fixed_for_kf = -1
        self.fuse_target_for_kf = -1
        self.loop_query = -1
        self.loop_words = 0
        self.reloc_query = -1
        self.reloc_words = 0
        self.place_recognition_query = -1
        self.place_recognition_words = 0
        self.ba_global_for_kf = -1
        self.Tcw_gba = None
        self.Tcw_bef_gba = None

    # ------------------------------------------------------------------
    def set_pose(self, Tcw: SE3):
        # normalized(): see SE3.normalized — unnormalized persistent poses
        # corrupt exponentially through re-anchoring chains
        self.Tcw = Tcw.normalized()
        self._Twc_cache = None

    @property
    def Twc(self) -> SE3:
        # lazy inverse, invalidated by set_pose (camera_center is called per
        # map point in frustum checks / normal updates — the repeated
        # inverse dominated those loops)
        cached = getattr(self, "_Twc_cache", None)
        if cached is None:
            cached = self.Tcw.inverse()
            self._Twc_cache = cached
        return cached

    def camera_center(self) -> np.ndarray:
        return self.Twc.t

    def features_in_area(self, x, y, r, min_level=-1, max_level=-1, right=False):
        return self._frame.features_in_area(x, y, r, min_level, max_level, right)

    @property
    def is_fisheye(self) -> bool:
        return self.camera2 is not None

    def get_right_pose(self) -> SE3:
        """World -> right camera (GetRightPose, KeyFrame.h:521)."""
        return (self.Trl * self.Tcw).normalized()

    def right_camera_center(self) -> np.ndarray:
        return self.get_right_pose().inverse().t

    def right_view(self):
        """Right-camera facet (shares _RightCameraView with Frame; uses
        THIS keyframe's map_points/pose, the source frame's grid)."""
        from orbslam3_tpu_torch.slam.frame import _RightCameraView

        if self._right_view is None:
            self._right_view = _RightCameraView(self)
        return self._right_view

    @property
    def _grid_w(self):
        return self._frame._grid_w

    @property
    def _grid_h(self):
        return self._frame._grid_h

    def unproject_stereo(self, i: int):
        z = self.depth[i]
        if z <= 0:
            return None
        if self.stereo_p3d is not None and i < self.n_left:
            return self.Twc * self.stereo_p3d[i]
        ray = self.camera.unproject(self.kps_un[i : i + 1])[0]
        return self.Twc * (ray * z)

    def erase_map_point_match(self, mp):
        """Clear EVERY slot holding `mp` (left and right for fisheye dual
        observations — KeyFrame::EraseMapPointMatch(MapPoint*))."""
        left, right = mp.observations.get(self, (-1, -1))
        for idx in (left, right):
            if idx >= 0 and self.map_points[idx] is mp:
                self.map_points[idx] = None
        self._mp_version += 1

    # --- covisibility --------------------------------------------------
    def update_connections(self, parent_candidates=True):
        """Count shared map points per keyframe; connect at weight >= 15
        (or the single best); refresh both sides; attach spanning-tree
        parent on first connection (KeyFrame::UpdateConnections)."""
        counter: dict[KeyFrame, int] = {}
        for mp in self.map_points:
            if mp is None or mp.bad:
                continue
            for kf in mp.observations:
                if kf.id == self.id or kf.bad:
                    continue
                counter[kf] = counter.get(kf, 0) + 1
        if not counter:
            return
        th = 15
        pairs = [(w, kf) for kf, w in counter.items() if w >= th]
        kf_max = max(counter.items(), key=lambda kv: kv[1])
        if not pairs:
            pairs = [(kf_max[1], kf_max[0])]
        for w, kf in pairs:
            kf.add_connection(self, w)
        self.connected_weights = {kf: w for w, kf in pairs}
        self._refresh_ordered()
        if self.first_connection and self.id != 0 and parent_candidates:
            self.parent = kf_max[0]
            self.parent.children.add(self)
            self.first_connection = False

    def add_connection(self, kf: "KeyFrame", weight: int):
        self.connected_weights[kf] = weight
        self._refresh_ordered()

    def erase_connection(self, kf: "KeyFrame"):
        if kf in self.connected_weights:
            del self.connected_weights[kf]
            self._refresh_ordered()

    def _refresh_ordered(self):
        items = sorted(self.connected_weights.items(), key=lambda kv: (-kv[1], kv[0].id))
        self.ordered_kfs = [kf for kf, _ in items]
        self.ordered_weights = [w for _, w in items]

    def get_best_covisibility_keyframes(self, n: int) -> list:
        return self.ordered_kfs[:n]

    def get_covisibles_by_weight(self, w: int) -> list:
        return [kf for kf, ww in zip(self.ordered_kfs, self.ordered_weights) if ww >= w]

    def get_connected_keyframes(self) -> list:
        return list(self.connected_weights.keys())

    def get_weight(self, kf) -> int:
        return self.connected_weights.get(kf, 0)

    # --- map points -----------------------------------------------------
    def add_map_point(self, mp, idx: int):
        self.map_points[idx] = mp
        self._mp_version += 1

    def erase_map_point_index(self, idx: int):
        self.map_points[idx] = None
        self._mp_version += 1

    def get_valid_map_points(self) -> list:
        """Cached non-None map-point slots (may contain duplicates for
        left/right stereo slots of the same point; callers dedup)."""
        if self._mp_cache_ver != self._mp_version:
            self._mp_cache = [mp for mp in self.map_points if mp is not None]
            self._mp_cache_ver = self._mp_version
        return self._mp_cache

    def tracked_map_points(self, min_obs: int) -> int:
        """Count of live (not bad) points with >= min_obs observations —
        called every frame by the new-KF policy, so it runs as two C passes
        (obs_counts is -1 exactly for None/bad slots)."""
        from orbslam3_tpu_torch.native import hostops

        mps = self.map_points
        return int(
            ((hostops.obs_counts(mps) >= 0)
             & (hostops.n_obs_of(mps) >= min_obs)).sum()
        )

    def get_map_point_indices(self):
        return [
            (i, mp)
            for i, mp in enumerate(self.map_points)
            if mp is not None and not mp.bad
        ]

    # --- lifecycle -------------------------------------------------------
    def set_bad(self):
        """Remove from graph, reparent children (KeyFrame::SetBadFlag)."""
        if self.map is not None and self.id == self.map.init_kf_id:
            return  # the map's initial KF is never erased (GetInitKFid role)
        if self.not_erase:
            self.to_be_erased = True
            return
        for kf in list(self.connected_weights):
            kf.erase_connection(self)
        for i, mp in enumerate(self.map_points):
            if mp is not None:
                mp.erase_observation(self)
        self.connected_weights.clear()
        self.ordered_kfs = []
        # reparent children to the best-covisible candidate among ancestors
        candidates = {self.parent} if self.parent else set()
        children = set(self.children)
        while children:
            best = None
            for child in children:
                if child.bad:
                    continue
                for kf in child.ordered_kfs:
                    if kf in candidates:
                        w = child.get_weight(kf)
                        if best is None or w > best[0]:
                            best = (w, child, kf)
            if best is None:
                break
            _, child, new_parent = best
            child.parent = new_parent
            new_parent.children.add(child)
            candidates.add(child)
            children.discard(child)
        for child in children:  # orphans to grandparent
            child.parent = self.parent
            if self.parent:
                self.parent.children.add(child)
        if self.parent:
            self.parent.children.discard(self)
            # relative pose to the (new) parent, stored at cull time so
            # trajectory replay can compose through culled reference KFs
            # (KeyFrame::mTcp, include/KeyFrame.h:392; used by
            # System::SaveTrajectoryTUM, src/System.cc:544+)
            self.Tcp = (self.Tcw * self.parent.Twc).normalized()
        # splice the inertial temporal chain (KeyFrame::SetBadFlag merges the
        # culled KF's preintegration into the next via MergePrevious and
        # relinks mPrevKF/mNextKF) — without this every cull permanently
        # truncates the chain and inertial BA windows shrink to the cull point
        if self.next_kf is not None and self.prev_kf is not None:
            if self.next_kf.imu_preint is not None and self.imu_preint is not None:
                self.next_kf.imu_preint.merge_previous(self.imu_preint)
            self.next_kf.prev_kf = self.prev_kf
            self.prev_kf.next_kf = self.next_kf
        elif self.next_kf is not None:
            self.next_kf.prev_kf = None
        elif self.prev_kf is not None:
            self.prev_kf.next_kf = None
        self.prev_kf = None
        self.next_kf = None
        self.bad = True
        if self.map is not None:
            self.map.erase_keyframe(self)
