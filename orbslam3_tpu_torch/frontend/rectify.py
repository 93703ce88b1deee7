"""Stereo rectification: Bouguet transforms, undistort-rectify maps, remap.

Role-parity with the reference's Settings::precomputeRectificationMaps
(ORB_SLAM3/include/Settings.h:157, src/Settings.cc) and the per-frame
remap applied by System::TrackStereo before tracking
(ORB_SLAM3/src/System.cc:253-263).  The reference delegates to
cv::stereoRectify / cv::initUndistortRectifyMap / cv::remap; here the
transforms and maps are re-derived in vectorized NumPy (validated against
cv2 in tests/test_rectify.py) so the framework is self-contained, and the
per-frame remap is OpenCV's INTER_LINEAR kernel reproduced bit for bit as
torch ops on an explicit device (`remap_bilinear`); no cv2 is needed.

Pipeline position: rectification runs BEFORE the device extractor —
exactly the reference's placement, on the System's device — so the
front-end always sees row-aligned stereo pairs and the row-constrained LR
matcher (frontend/stereo_frame.py) is valid on raw EuRoC-style input.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch._device import resolve_device
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


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) for float32 values held in float64 tensors: a * b is
    exact in float64, the sum is rounded to odd (TwoSum, then one ulp
    toward the exact value when inexact and even), so the one rounding to
    float32 that follows is the correctly rounded fused result."""
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, s + err), s)
    return s.to(torch.float32)


def remap_bilinear(img: torch.Tensor, mapx: torch.Tensor, mapy: torch.Tensor) -> torch.Tensor:
    """cv::remap(img, mapx, mapy, INTER_LINEAR, BORDER_CONSTANT 0) for a
    uint8 (H, W) image and float32 (Ho, Wo) maps, bit for bit, computed on
    img's device; a leading batch axis on all three remaps B images at
    once (the two cameras of a pair in one pass).

    OpenCV 5's kernel works in float32 with fused multiply-adds (its 4.x
    kernel used 1/32-px fixed point; tests/test_torch_cv2_free.py holds
    this one to the cv2 it runs against): per output pixel the taps at
    (floor(x), floor(y)) and their right / lower neighbours, each tap
    outside the image reading 0, then
    v0 = fma(ax, p01 - p00, p00), v1 = fma(ax, p11 - p10, p10),
    v = fma(ay, v1 - v0, v0), rounded half to even and saturated to u8.
    Map coordinates that are not finite read 0, as cv2's do."""
    h, w = img.shape[-2:]
    dev = img.device
    batch = img.reshape(-1, h, w)
    n = batch.shape[0]
    mapx = torch.nan_to_num(mapx.to(dev, torch.float32), nan=-8.0, posinf=w + 8.0, neginf=-8.0)
    mapy = torch.nan_to_num(mapy.to(dev, torch.float32), nan=-8.0, posinf=h + 8.0, neginf=-8.0)
    fx, fy = torch.floor(mapx), torch.floor(mapy)
    ax, ay = (mapx - fx).double(), (mapy - fy).double()  # exact in float32
    # a 2-px zero border reads 0 for every tap outside: a tap more than one
    # pixel outside is clamped into the border
    padded = torch.nn.functional.pad(batch, (2, 2, 2, 2)).reshape(-1)
    pw = w + 4
    base = (fy.clamp(-2, h).to(torch.int64) + 2) * pw + fx.clamp(-2, w).to(torch.int64) + 2
    base = (base.reshape(n, -1) + torch.arange(n, device=dev)[:, None] * ((h + 4) * pw)).reshape(
        mapx.shape
    )
    taps = padded[torch.stack([base, base + 1, base + pw, base + pw + 1])].double()
    p00, p01, p10, p11 = taps.unbind(0)
    v0 = _fma_f32(ax, p01 - p00, p00)
    v1 = _fma_f32(ax, p11 - p10, p10)
    v = _fma_f32(ay, (v1 - v0).double(), v0.double())
    return torch.round(v).clamp(0, 255).to(torch.uint8)


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

    def rectify(self, img_l: np.ndarray, img_r: np.ndarray, device: str | torch.device = "cuda"):
        """Both images remapped on `device` -> two uint8 (H, W) tensors
        there; the maps move to a device once."""
        dev = resolve_device(device)
        on_device = self.__dict__.setdefault("_device_maps", {})  # torch.device -> maps
        maps = on_device.get(dev)
        if maps is None:  # (2, H, W) x and y maps of both cameras
            maps = tuple(torch.from_numpy(np.stack(m)).to(dev)
                         for m in ((self.map1x, self.map2x), (self.map1y, self.map2y)))
            on_device[dev] = maps
        pair = torch.from_numpy(np.ascontiguousarray(np.stack([img_l, img_r])))
        left, right = remap_bilinear(pair.to(dev, non_blocking=True), *maps).unbind(0)
        return left, right
