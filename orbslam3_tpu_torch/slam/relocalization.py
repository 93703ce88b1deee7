"""Relocalization: recover a lost frame's pose from the keyframe database.

Role-parity with Tracking::Relocalization (ORB_SLAM3/src/
Tracking5.cc:44): query DetectRelocalizationCandidates, match each
candidate by BoW, solve RANSAC PnP, optimize, and widen with guided
projection search until >= 50 inliers.
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.optim.pnp import pnp_ransac
from orbslam3_tpu_torch.optim.pose_optimization import PoseObservations, pose_optimization
from orbslam3_tpu_torch.slam import matchers


def _search_by_projection_reloc(frame, kf, found, th, orb_dist):
    """Guided search for additional KF map-point matches (ORBmatcher
    SearchByProjection frame-vs-KF overload used only by relocalization)."""
    n_new = 0
    tcw = frame.Tcw
    for i, mp in kf.get_map_point_indices():
        if mp in found:
            continue
        pc = tcw * mp.position
        if pc[2] <= 0:
            continue
        uv = frame.camera.project(pc[None])[0]
        if not (frame.min_x < uv[0] < frame.max_x and frame.min_y < uv[1] < frame.max_y):
            continue
        dist = np.linalg.norm(mp.position - frame.camera_center())
        if not (mp.min_distance <= dist <= mp.max_distance):
            continue
        level = mp.predict_scale(dist, frame)
        r = th * frame.scale_factors[level]
        idx = frame.features_in_area(uv[0], uv[1], r, level - 1, level + 1)
        if len(idx) == 0:
            continue
        free = [j for j in idx if frame.map_points[j] is None]
        if not free:
            continue
        dists = matchers.desc_distances(mp.descriptor, frame.desc[free])
        j = int(np.argmin(dists))
        if int(dists[j]) <= orb_dist:
            frame.map_points[free[j]] = mp
            found.add(mp)
            n_new += 1
    return n_new


class Relocalizer:
    def __init__(self, kf_database, min_inliers: int = 50):
        self.db = kf_database
        self.min_inliers = min_inliers

    def __call__(self, frame) -> bool:
        if frame.bow_vec is None:
            frame.bow_vec, frame.feat_vec = self.db.voc.transform(frame.desc)
        candidates = self.db.detect_relocalization_candidates(frame)
        if not candidates:
            return False
        for kf in candidates:
            if kf.bad:
                continue
            matches, n = matchers.search_by_bow(kf, frame, ratio=0.75)
            if n < 15:
                continue
            # PnP consumes left-camera pixels only (fisheye right-block
            # BoW matches re-enter below through the ToBody rows of
            # _optimize; MLPnP's bearing model is single-camera)
            idx = np.asarray(
                sorted(i for i in matches.keys() if i < frame.n_left)
            )
            if len(idx) < 6:
                continue
            pw = np.stack([matches[i].position for i in idx])
            T, inl = pnp_ransac(
                pw,
                frame.kps_un[idx],
                frame.camera,
                frame.inv_level_sigma2[frame.octave[idx]],
            )
            if T is None:
                continue
            frame.set_pose(T)
            frame.map_points[:] = None
            found = set()
            for k_i, i in enumerate(idx):
                if inl[k_i]:
                    frame.map_points[i] = matches[i]
                    found.add(matches[i])
            n_good = self._optimize(frame)
            if n_good < 10:
                continue
            if n_good < self.min_inliers:
                _search_by_projection_reloc(frame, kf, found, th=10, orb_dist=100)
                n_good = self._optimize(frame)
                if self.min_inliers * 0.6 < n_good < self.min_inliers:
                    _search_by_projection_reloc(frame, kf, found, th=3, orb_dist=64)
                    n_good = self._optimize(frame)
            if n_good >= self.min_inliers:
                for i in np.nonzero(frame.outlier)[0]:
                    frame.map_points[i] = None
                    frame.outlier[i] = False
                return True
        return False

    def _optimize(self, frame) -> int:
        idx = [
            i
            for i in range(frame.n)
            if frame.map_points[i] is not None and not frame.map_points[i].bad
        ]
        if len(idx) < 3:
            return 0
        idx = np.asarray(idx)
        obs = PoseObservations(
            p3d_w=np.stack([frame.map_points[i].position for i in idx]),
            obs_uv=frame.kps_un[idx],
            obs_ur=frame.u_right[idx],
            inv_sigma2=frame.inv_level_sigma2[frame.octave[idx]],
            camera=frame.camera,
            mbf=frame.mbf,
            is_right=(
                (idx >= frame.n_left) if frame.camera2 is not None else None
            ),
            camera2=frame.camera2,
            Trl=frame.Trl,
        )
        T, inlier, n_in = pose_optimization(frame.Tcw, obs)
        frame.set_pose(T)
        frame.outlier[:] = False
        for k, i in enumerate(idx):
            if not inlier[k]:
                frame.outlier[i] = True
        return n_in
