"""Host-side Frame container.

Mirrors the role of the reference Frame (ORB_SLAM3/include/Frame.h:53,
src/Frame.cc) — per-frame keypoints/descriptors, stereo depths, pose, the
64x48 feature grid for windowed queries, frustum checks — consuming the
device front-end's FrameFeatures block instead of running extraction
in-line.  Data lives in flat NumPy arrays (structure-of-arrays), not
per-keypoint objects; all queries are vectorized.
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.utils.lie import SE3

GRID_COLS = 64
GRID_ROWS = 48


class Frame:
    _next_id = 0

    def __init__(
        self,
        kps: np.ndarray,          # (N, 2) keypoint pixels (raw)
        octave: np.ndarray,       # (N,)
        angle: np.ndarray,        # (N,)
        response: np.ndarray,     # (N,)
        desc: np.ndarray,         # (N, 32) uint8
        camera,
        scale_factors: np.ndarray,
        timestamp: float = 0.0,
        u_right: np.ndarray | None = None,
        depth: np.ndarray | None = None,
        mbf: float = 0.0,
        n_left: int | None = None,
        camera2=None,
        Tlr: SE3 | None = None,
        left_to_right: np.ndarray | None = None,
        right_to_left: np.ndarray | None = None,
        stereo_p3d: np.ndarray | None = None,
    ):
        self.id = Frame._next_id
        Frame._next_id += 1
        self.timestamp = timestamp
        self.camera = camera
        self.mbf = mbf
        self.mb = mbf / camera.fx if mbf > 0 else 0.0

        self.kps = np.asarray(kps, np.float64)
        self.octave = np.asarray(octave, np.int32)
        self.angle = np.asarray(angle, np.float32)
        self.response = np.asarray(response, np.float32)
        self.desc = np.asarray(desc, np.uint8)
        self.n = len(self.kps)
        # dual-camera (fisheye stereo) layout: keypoints [0, n_left) belong
        # to the left camera, [n_left, n) to the right camera (the reference
        # Frame's Nleft/Nright concatenation, include/Frame.h:329-334).
        # Non-fisheye frames keep n_left == n (every index is "left").
        self.camera2 = camera2
        self.n_left = self.n if n_left is None else int(n_left)
        self.n_right = self.n - self.n_left
        self.Tlr = Tlr  # pose of right camera in the left frame (mTlr)
        self.Trl = Tlr.inverse() if Tlr is not None else None
        self.left_to_right = (
            np.asarray(left_to_right, np.int64)
            if left_to_right is not None
            else None
        )
        self.right_to_left = (
            np.asarray(right_to_left, np.int64)
            if right_to_left is not None
            else None
        )
        # triangulated stereo points in the LEFT camera frame for matched
        # left keypoints (mvStereo3Dpoints role; Frame.cc:1156-1191)
        self.stereo_p3d = (
            np.asarray(stereo_p3d, np.float64) if stereo_p3d is not None else None
        )
        self.u_right = (
            np.asarray(u_right, np.float64)
            if u_right is not None
            else np.full(self.n, -1.0)
        )
        self.depth = (
            np.asarray(depth, np.float64) if depth is not None else np.full(self.n, -1.0)
        )

        self.scale_factors = np.asarray(scale_factors, np.float64)
        self.inv_scale_factors = 1.0 / self.scale_factors
        self.level_sigma2 = self.scale_factors**2
        self.inv_level_sigma2 = 1.0 / self.level_sigma2
        self.n_levels = len(scale_factors)
        self.log_scale_factor = float(np.log(self.scale_factors[1] / self.scale_factors[0])) if self.n_levels > 1 else 1.0

        # undistorted keypoints (pinhole distortion; fisheye kps stay raw,
        # Frame::UndistortKeyPoints semantics)
        if hasattr(camera, "undistort_points"):
            self.kps_un = camera.undistort_points(self.kps) if self.n else self.kps.copy()
        else:
            self.kps_un = self.kps.copy()

        # pose (world -> camera)
        self.Tcw: SE3 | None = None

        # map point associations
        self.map_points = np.full(self.n, None, dtype=object)
        self.outlier = np.zeros(self.n, bool)

        # image bounds (for grid + frustum); set from camera/keypoints
        if self.n:
            self.min_x = float(self.kps_un[:, 0].min()) - 1
            self.max_x = float(self.kps_un[:, 0].max()) + 1
            self.min_y = float(self.kps_un[:, 1].min()) - 1
            self.max_y = float(self.kps_un[:, 1].max()) + 1
        else:
            self.min_x, self.max_x, self.min_y, self.max_y = 0.0, 1.0, 0.0, 1.0
        self._build_grid()

        self.ref_keyframe = None

    # ------------------------------------------------------------------
    def set_image_bounds(self, min_x, min_y, max_x, max_y):
        self.min_x, self.min_y, self.max_x, self.max_y = (
            float(min_x),
            float(min_y),
            float(max_x),
            float(max_y),
        )
        self._build_grid()

    @property
    def is_fisheye(self) -> bool:
        return self.camera2 is not None

    def _make_grid(self, kps: np.ndarray):
        """64x48 bucketing of a keypoint block (AssignFeaturesToGrid
        semantics).  Returns (order, starts) with LOCAL indices."""
        cx = ((kps[:, 0] - self.min_x) / self._grid_w).astype(np.int64)
        cy = ((kps[:, 1] - self.min_y) / self._grid_h).astype(np.int64)
        ok = (cx >= 0) & (cx < GRID_COLS) & (cy >= 0) & (cy < GRID_ROWS)
        cell = np.where(ok, cy * GRID_COLS + cx, GRID_COLS * GRID_ROWS)
        order = np.argsort(cell, kind="stable")
        starts = np.searchsorted(cell[order], np.arange(GRID_COLS * GRID_ROWS + 1))
        return order, starts

    def _build_grid(self):
        """Left-camera grid (all keypoints for single-camera frames) plus a
        second grid over the right-camera block for fisheye frames
        (mGridRight, include/Frame.h:343)."""
        self._grid_w = (self.max_x - self.min_x) / GRID_COLS
        self._grid_h = (self.max_y - self.min_y) / GRID_ROWS
        self._grid_order, self._grid_starts = self._make_grid(
            self.kps_un[: self.n_left]
        )
        if self.n_right > 0:
            self._grid_order_r, self._grid_starts_r = self._make_grid(
                self.kps_un[self.n_left :]
            )
        else:
            self._grid_order_r = self._grid_starts_r = None
        self._right_view = None  # rebuilt lazily on demand

    def set_pose(self, Tcw: SE3):
        # normalized(): see SE3.normalized — unnormalized persistent poses
        # corrupt exponentially through re-anchoring chains
        self.Tcw = Tcw.normalized()
        self._Twc_cache = None

    @property
    def Twc(self) -> SE3:
        cached = getattr(self, "_Twc_cache", None)
        if cached is None:
            cached = self.Tcw.inverse()
            self._Twc_cache = cached
        return cached

    def camera_center(self) -> np.ndarray:
        return self.Twc.t

    # ------------------------------------------------------------------
    def features_in_area(
        self,
        x: float,
        y: float,
        r: float,
        min_level: int = -1,
        max_level: int = -1,
        right: bool = False,
    ) -> np.ndarray:
        """Indices of keypoints within the square window (GetFeaturesInArea).

        `right=True` queries the right-camera grid of a fisheye frame
        (bRight flag of the reference's GetFeaturesInArea); returned indices
        are GLOBAL (offset by n_left)."""
        if right:
            order, starts, off = self._grid_order_r, self._grid_starts_r, self.n_left
        else:
            order, starts, off = self._grid_order, self._grid_starts, 0
        cx0 = max(0, int((x - self.min_x - r) / self._grid_w))
        cx1 = min(GRID_COLS - 1, int((x - self.min_x + r) / self._grid_w))
        cy0 = max(0, int((y - self.min_y - r) / self._grid_h))
        cy1 = min(GRID_ROWS - 1, int((y - self.min_y + r) / self._grid_h))
        if cx1 < cx0 or cy1 < cy0:
            return np.empty(0, np.int64)
        chunks = []
        for cy in range(cy0, cy1 + 1):
            a = starts[cy * GRID_COLS + cx0]
            b = starts[cy * GRID_COLS + cx1 + 1]
            if b > a:
                chunks.append(order[a:b])
        if not chunks:
            return np.empty(0, np.int64)
        idx = np.concatenate(chunks) + off
        kp = self.kps_un[idx]
        ok = (np.abs(kp[:, 0] - x) < r) & (np.abs(kp[:, 1] - y) < r)
        if min_level >= 0:
            ok &= self.octave[idx] >= min_level
        if max_level >= 0:
            ok &= self.octave[idx] <= max_level
        return idx[ok]

    def unproject_stereo(self, i: int) -> np.ndarray | None:
        """Back-project keypoint i using its stereo depth (world frame).

        Fisheye frames with a stereo match use the triangulated two-view
        point directly (UnprojectStereoFishEye, mvStereo3Dpoints role)
        rather than ray*depth — identical z, exact (x, y)."""
        z = self.depth[i]
        if z <= 0:
            return None
        if self.stereo_p3d is not None and i < self.n_left:
            return self.Twc * self.stereo_p3d[i]
        ray = self.camera.unproject(self.kps_un[i : i + 1])[0]
        pc = ray * z
        return self.Twc * pc

    def unproject_stereo_batch(self, idxs: np.ndarray) -> np.ndarray:
        """(N, 3) world points for keypoints idxs (caller ensures depth>0)."""
        twc = self.Twc
        if self.stereo_p3d is not None:
            return self.stereo_p3d[idxs] @ twc.R.T + twc.t
        rays = self.camera.unproject(self.kps_un[idxs])
        pc = rays * self.depth[idxs][:, None]
        return pc @ twc.R.T + twc.t

    def is_in_frustum(self, mp, view_cos_limit: float = 0.5, right: bool = False):
        """Vectorless single-point frustum check (Frame::isInFrustum;
        `right=True` is the fisheye isInFrustumChecks(..., bRight) path —
        right-camera pose Trl*Tcw, projection through camera2).

        Returns None if not visible, else (u, v, ur, level, view_cos)."""
        if right:
            tcw = self.Trl * self.Tcw
            cam = self.camera2
            center = tcw.inverse().t
        else:
            tcw = self.Tcw
            cam = self.camera
            center = self.camera_center()
        p = mp.position
        pc = tcw * p
        if pc[2] < 0.1:
            return None
        uv = cam.project(pc[None, :])[0]
        if not (self.min_x < uv[0] < self.max_x and self.min_y < uv[1] < self.max_y):
            return None
        dist = np.linalg.norm(p - center)
        if not (mp.min_distance <= dist <= mp.max_distance):
            return None
        normal = mp.normal
        view_cos = float((p - center) @ normal / max(dist, 1e-9))
        if view_cos < view_cos_limit:
            return None
        level = mp.predict_scale(dist, self)
        ur = uv[0] - self.mbf / pc[2] if (self.mbf > 0 and not right) else -1.0
        return uv[0], uv[1], ur, level, view_cos

    def right_view(self) -> "_RightCameraView":
        """Right-camera facet of a fisheye frame (see _RightCameraView)."""
        if self._right_view is None:
            self._right_view = _RightCameraView(self)
        return self._right_view


class _RightCameraView:
    """The right-camera block of a fisheye Frame/KeyFrame exposed as a
    standalone pseudo-frame: LOCAL indices over the right keypoints, the
    right-image grid, camera2, and the derived right-camera pose Trl*Tcw.

    This is how the single-camera matcher cores (search_by_projection_*)
    run unchanged against the second camera — `map_points`/`outlier` are
    live NumPy views into the parent's arrays, so an association written at
    local index j lands at parent index n_left + j, which is exactly the
    reference's mvpMapPoints[Nleft + idx] bookkeeping
    (ORB_SLAM3/src/ORBmatcher3.cc SearchByProjection bRight branches).
    """

    def __init__(self, parent):
        self._p = parent

    # --- feature block (NumPy views; writes propagate) -----------------
    @property
    def n(self):
        return self._p.n_right

    @property
    def n_left(self):
        return self._p.n_right  # every view index is "left" to the cores

    @property
    def kps(self):
        return self._p.kps[self._p.n_left :]

    @property
    def kps_un(self):
        return self._p.kps_un[self._p.n_left :]

    @property
    def octave(self):
        return self._p.octave[self._p.n_left :]

    @property
    def angle(self):
        return self._p.angle[self._p.n_left :]

    @property
    def desc(self):
        return self._p.desc[self._p.n_left :]

    @property
    def u_right(self):
        return self._p.u_right[self._p.n_left :]

    @property
    def map_points(self):
        return self._p.map_points[self._p.n_left :]

    @property
    def outlier(self):
        return self._p.outlier[self._p.n_left :]

    # --- camera/pose ----------------------------------------------------
    @property
    def camera(self):
        return self._p.camera2

    @property
    def camera2(self):
        return None  # the view itself is single-camera

    @property
    def Tcw(self):
        return (self._p.Trl * self._p.Tcw).normalized()

    @property
    def Twc(self):
        return self.Tcw.inverse()

    def camera_center(self):
        return self.Twc.t

    mbf = 0.0
    mb = 0.0

    # --- shared metadata -------------------------------------------------
    @property
    def scale_factors(self):
        return self._p.scale_factors

    @property
    def level_sigma2(self):
        return self._p.level_sigma2

    @property
    def inv_level_sigma2(self):
        return self._p.inv_level_sigma2

    @property
    def n_levels(self):
        return self._p.n_levels

    @property
    def log_scale_factor(self):
        return self._p.log_scale_factor

    @property
    def min_x(self):
        return self._p.min_x

    @property
    def max_x(self):
        return self._p.max_x

    @property
    def min_y(self):
        return self._p.min_y

    @property
    def max_y(self):
        return self._p.max_y

    @property
    def _grid_w(self):
        return self._p._grid_w

    @property
    def _grid_h(self):
        return self._p._grid_h

    def features_in_area(self, x, y, r, min_level=-1, max_level=-1):
        idx = self._p.features_in_area(x, y, r, min_level, max_level, right=True)
        return idx - self._p.n_left
