"""Stereo rectification: Bouguet transforms, undistort-rectify maps, remap.

Role-parity with the reference's Settings::precomputeRectificationMaps
(ORB_SLAM3/include/Settings.h:157, src/Settings.cc) and the per-frame
remap applied by System::TrackStereo before tracking
(ORB_SLAM3/src/System.cc:253-263).  The reference delegates to
cv::stereoRectify / cv::initUndistortRectifyMap / cv::remap; here the
transforms and maps are re-derived in vectorized NumPy (validated against
cv2 in tests/test_rectify.py) so the framework is self-contained, while the
per-frame remap uses cv2.remap when available (it is ~10x faster than the
NumPy path and bit-compatible within fixed-point rounding).

Pipeline position: rectification runs on host BEFORE the device extractor —
exactly the reference's placement — so the device front-end always sees
row-aligned stereo pairs and the row-constrained LR matcher
(frontend/stereo_frame.py) is valid on raw EuRoC-style input.
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.utils.lie import so3_exp, so3_log


def stereo_rectify(
    K1: np.ndarray,
    D1: np.ndarray | None,
    K2: np.ndarray | None,
    D2: np.ndarray | None,
    size: tuple[int, int],
    R: np.ndarray,
    t: np.ndarray,
    new_size: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Bouguet stereo rectification (cv::stereoRectify, CALIB_ZERO_DISPARITY,
    alpha=-1 default scaling).

    K1/K2: 3x3 intrinsics; D1/D2: radtan distortion or None;
    size: source (width, height); (R, t): cam1 -> cam2 (x2 = R x1 + t);
    new_size: optional rectified output size (Camera.newWidth/newHeight).
    Returns (R1, R2, P1, P2): per-camera rectifying rotations and new 3x4
    projection matrices (P2[0,3] = fx * baseline_x).
    """
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64).reshape(3)
    nx, ny = size
    new_w, new_h = new_size if new_size is not None else size
    if K2 is None:
        K2 = K1

    # split the relative rotation evenly between the two cameras
    om = so3_log(R)
    r_r = so3_exp(-0.5 * om)
    t_half = r_r @ t

    # x-axis of the rectified frame along the baseline
    idx = 0 if abs(t_half[0]) > abs(t_half[1]) else 1
    uu = np.zeros(3)
    uu[idx] = 1.0 if t_half[idx] > 0 else -1.0
    ww = np.cross(t_half, uu)
    nw = np.linalg.norm(ww)
    nt = np.linalg.norm(t_half)
    if nw > 0.0:
        ww = ww * (np.arccos(abs(t_half[idx]) / nt) / nw)
    wR = so3_exp(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t_new = R2 @ t

    # common focal length: mean of the cross-axis focals, scaled by the
    # output/input size ratio along the rectification axis (modern OpenCV
    # stereoRectify with newImageSize)
    ratio = (new_w / nx if idx == 1 else new_h / ny) / 2.0
    fc_new = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * ratio

    # new principal points: average the rectified positions of the image
    # corners per camera, then (ZERO_DISPARITY) share the mean
    cc_new = np.zeros((2, 2))
    from orbslam3_tpu_torch.cameras.models import Pinhole

    for k, (K, D, Rk) in enumerate(((K1, D1, R1), (K2, D2, R2))):
        cam = Pinhole([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], D)
        corners = np.array(
            [[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]], np.float64
        )
        und = cam.undistort_points(corners)  # undistorted pixels (source K)
        rays = cam.unproject(und)            # normalized camera rays
        rect = rays @ Rk.T
        rect = rect[:, :2] / rect[:, 2:3]
        avg = fc_new * rect.mean(axis=0)
        cc_new[k, 0] = (new_w - 1) / 2 - avg[0]
        cc_new[k, 1] = (new_h - 1) / 2 - avg[1]
    cc = cc_new.mean(axis=0)

    P1 = np.array(
        [[fc_new, 0, cc[0], 0], [0, fc_new, cc[1], 0], [0, 0, 1, 0.0]]
    )
    P2 = P1.copy()
    P2[idx, 3] = fc_new * t_new[idx]
    return R1, R2, P1, P2


def init_undistort_rectify_map(
    K: np.ndarray,
    D: np.ndarray | None,
    R: np.ndarray,
    P: np.ndarray,
    size: tuple[int, int],
    fisheye: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """cv::initUndistortRectifyMap semantics: per rectified pixel, the source
    (distorted) pixel to sample.  Returns float32 (H, W) mapx, mapy."""
    nx, ny = size
    P3 = np.asarray(P, np.float64)[:, :3]
    iR = np.linalg.inv(P3 @ np.asarray(R, np.float64))
    u, v = np.meshgrid(np.arange(nx, dtype=np.float64), np.arange(ny, dtype=np.float64))
    ones = np.ones_like(u)
    pts = np.stack([u, v, ones], axis=-1) @ iR.T  # (H, W, 3)
    x = pts[..., 0] / pts[..., 2]
    y = pts[..., 1] / pts[..., 2]
    if fisheye:
        r = np.sqrt(x * x + y * y)
        theta = np.arctan(r)
        k = np.zeros(4)
        if D is not None:
            k[: len(D)] = np.asarray(D).ravel()[:4]
        t2 = theta * theta
        td = theta * (1 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
        scale = np.where(r > 1e-12, td / np.maximum(r, 1e-12), 1.0)
        xd, yd = x * scale, y * scale
    elif D is not None:
        k = np.zeros(5)
        kk = np.asarray(D).ravel()
        k[: len(kk)] = kk
        r2 = x * x + y * y
        radial = 1 + k[0] * r2 + k[1] * r2 * r2 + k[4] * r2 * r2 * r2
        xd = x * radial + 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x)
        yd = y * radial + k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y
    else:
        xd, yd = x, y
    mapx = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    mapy = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return mapx, mapy


def remap_bilinear(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray) -> np.ndarray:
    """Bilinear remap with zero border (cv::remap INTER_LINEAR,
    BORDER_CONSTANT 0).  Uses cv2 when importable, NumPy otherwise."""
    try:
        import cv2

        return cv2.remap(img, mapx, mapy, cv2.INTER_LINEAR)
    except ImportError:
        pass
    h, w = img.shape[:2]
    x = np.asarray(mapx, np.float64)
    y = np.asarray(mapy, np.float64)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = x - x0
    fy = y - y0

    def sample(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        vals = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(np.float64)
        return np.where(inside, vals, 0.0)

    out = (
        sample(y0, x0) * (1 - fx) * (1 - fy)
        + sample(y0, x0 + 1) * fx * (1 - fy)
        + sample(y0 + 1, x0) * (1 - fx) * fy
        + sample(y0 + 1, x0 + 1) * fx * fy
    )
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.round(out), 0, 255).astype(img.dtype)
    return out.astype(img.dtype)


class StereoRectifier:
    """Precomputed rectification state for a stereo rig
    (Settings::precomputeRectificationMaps role).

    Built once from unrectified calibration; per frame `rectify()` remaps
    both images into the common rectified pinhole frame.  After
    construction, `.camera` is the rectified Pinhole (no distortion),
    `.bf` the rectified baseline*focal product to feed the row matcher.
    """

    def __init__(
        self,
        cam1,
        cam2,
        Tlr,
        size: tuple[int, int],
        fisheye: bool = False,
        new_size: tuple[int, int] | None = None,
    ):
        """cam1/cam2: camera models with .K() and .dist (source calibration);
        Tlr: SE3 cam1(left) -> cam2-frame convention T_c1_c2 (pose of cam2 in
        cam1: x_c1 = Tlr * x_c2, the reference's Stereo.T_c1_c2); size (w, h)
        of the SOURCE images; new_size: optional rectified output size
        (the maps fold the Camera.newWidth/newHeight resize in, as the
        reference's precomputeRectificationMaps does via newImSize_).
        """
        from orbslam3_tpu_torch.cameras.models import Pinhole

        # (R, t) with x2 = R x1 + t   <-  inverse of T_c1_c2
        Trl = Tlr.inverse()
        R, t = Trl.R, Trl.t
        D1 = getattr(cam1, "dist", None)
        D2 = getattr(cam2, "dist", None)
        if fisheye:
            D1 = cam1.params[4:8]
            D2 = cam2.params[4:8]
        out_size = new_size if new_size is not None else size
        R1, R2, P1, P2 = stereo_rectify(
            cam1.K(), D1, cam2.K(), D2, size, R, t, new_size
        )
        self.R1, self.R2, self.P1, self.P2 = R1, R2, P1, P2
        self.map1x, self.map1y = init_undistort_rectify_map(
            cam1.K(), D1, R1, P1, out_size, fisheye
        )
        self.map2x, self.map2y = init_undistort_rectify_map(
            cam2.K(), D2, R2, P2, out_size, fisheye
        )
        self.camera = Pinhole([P1[0, 0], P1[1, 1], P1[0, 2], P1[1, 2]], None)
        # rectified baseline * focal (Settings: b_ * calibration1_->getParameter(0))
        self.bf = float(abs(P2[0, 3]))
        self.size = out_size

    def rectify(self, img_l: np.ndarray, img_r: np.ndarray):
        return (
            remap_bilinear(img_l, self.map1x, self.map1y),
            remap_bilinear(img_r, self.map2x, self.map2y),
        )
