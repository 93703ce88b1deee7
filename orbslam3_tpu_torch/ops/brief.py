"""Rotated-BRIEF (rBRIEF) 256-bit descriptors.

Counterpart of ``orbslam3_tpu/ops/brief.py``: rotate the 512 pattern points
in f32 with the reference's expression order, round half to even
(`torch.round`, as `jnp.rint`, C-h4), sample the 37x37 window around each
keypoint, compare the 256 pairs and pack bits LSB-first per byte (even
samples < odd samples).  By default the samples are picks out of B2
windows: the windows may come gathered already (`brief_window_starts`
gives their starts: they do not depend on the angles), so that one B2
launch serves orientation and rBRIEF.  With `fused` the whole function is
one launch of the rBRIEF mode of ``csrc/sample_windows.cu`` (B5, which
replaces ``_sample_windows_pallas`` and folds in the arithmetic the
reference runs around it); `brief_descriptors_plain` is its plain twin.
Bit-exact given the same (cos, sin); pass `trig` to pin them, since
platform trig may differ by ulps (C-h2).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch._device import stream_handle
from orbslam3_tpu_torch.ops.brief_pattern import BIT_PATTERN_31
from orbslam3_tpu_torch.ops.pyramid import reflect101_pad
from orbslam3_tpu_torch.ops.window_gather import sample_windows, sample_windows_plain

BRIEF_PAD = 19   # border width of the sampling buffer (reference EDGE_THRESHOLD)
PATCH_HALF = 18  # max rounded rotated pattern offset
BRIEF_WINDOW = 2 * PATCH_HALF + 1
PATTERN_POINTS = 512

_FACTOR_PI = float(np.float32(math.pi / 180.0))


def brief_pattern_np() -> np.ndarray:
    """(2, 512) f32 pattern points (px, py); even = p0, odd = p1."""
    px = BIT_PATTERN_31[:, [0, 2]].reshape(-1)
    py = BIT_PATTERN_31[:, [1, 3]].reshape(-1)
    return np.stack([px, py]).astype(np.float32)


def brief_pattern(device) -> torch.Tensor:
    return torch.from_numpy(brief_pattern_np()).to(device)


def brief_sampling_image(raw: torch.Tensor, blurred: torch.Tensor) -> torch.Tensor:
    """Blurred interior inside a reflect-101 border of the raw level image."""
    pad = reflect101_pad(raw, BRIEF_PAD)
    pad[BRIEF_PAD:-BRIEF_PAD, BRIEF_PAD:-BRIEF_PAD] = blurred
    return pad


def brief_window_starts(xy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(row0, col0) in the sampling image of the BRIEF_WINDOW x BRIEF_WINDOW
    windows around keypoints at xy (N, 2) f32 level coords (un-bordered)."""
    cy = torch.round(xy[:, 1]).to(torch.int32) + BRIEF_PAD
    cx = torch.round(xy[:, 0]).to(torch.int32) + BRIEF_PAD
    return cy - PATCH_HALF, cx - PATCH_HALF


def brief_indices(angles_deg, trig, pattern) -> tuple[torch.Tensor, torch.Tensor]:
    """(ridx, cidx) (N, 512) int32 in the BRIEF window: the pattern points
    rotated by the angles (or the pinned (cos, sin)), rounded half to even."""
    if trig is not None:
        a = trig[0].to(torch.float32)[:, None]
        b = trig[1].to(torch.float32)[:, None]
    else:
        ang = angles_deg.to(torch.float32) * _FACTOR_PI
        a = torch.cos(ang)[:, None]
        b = torch.sin(ang)[:, None]
    px = pattern[0][None, :]
    py = pattern[1][None, :]
    r_off = torch.round(px * b + py * a).to(torch.int32)  # (N, 512) in [-18, 18]
    c_off = torch.round(px * a - py * b).to(torch.int32)
    return r_off + PATCH_HALF, c_off + PATCH_HALF


def _pack(samples: torch.Tensor) -> torch.Tensor:
    bits = (samples[:, 0::2] < samples[:, 1::2]).to(torch.int32).reshape(-1, 32, 8)
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    return (bits << shifts).sum(dim=-1, dtype=torch.int32).to(torch.uint8)


def brief_descriptors_plain(
    sampling_img: torch.Tensor,
    xy: torch.Tensor,
    angles_deg: torch.Tensor,
    trig: tuple[torch.Tensor, torch.Tensor] | None = None,
    pattern: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch twin of the rBRIEF kernel: the rotation, the window
    starts and the picks over `gather_windows_plain`, the compares and the
    pack.  Launches no hand-written kernel."""
    if pattern is None:
        pattern = brief_pattern(sampling_img.device)
    ridx, cidx = brief_indices(angles_deg, trig, pattern)
    samples = sample_windows_plain(
        sampling_img, *brief_window_starts(xy), ridx, cidx, BRIEF_WINDOW, BRIEF_WINDOW
    )
    return _pack(samples)


def _check_fused(sampling_img, xy, angles_deg, trig, pattern) -> None:
    if sampling_img.dim() != 2 or sampling_img.dtype != torch.uint8:
        raise ValueError(
            "the fused rBRIEF kernel takes the 2-D uint8 sampling image, got "
            f"{sampling_img.dtype} {tuple(sampling_img.shape)}"
        )
    h, w = sampling_img.shape
    if h < BRIEF_WINDOW or w < BRIEF_WINDOW or h * w >= 2**31:
        raise ValueError(
            f"the sampling image must be at least {BRIEF_WINDOW}x{BRIEF_WINDOW} with fewer "
            f"than 2^31 pixels, got {h}x{w}"
        )
    dev = sampling_img.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if xy.dim() != 2 or xy.shape[1] != 2:
        raise ValueError(f"xy must be (K, 2), got {tuple(xy.shape)}")
    k = xy.shape[0]
    per_kp = [angles_deg] if trig is None else list(trig)
    if any(t.shape != (k,) for t in per_kp):
        raise ValueError("angles (or the pinned cos and sin) must be (K,) with K = len(xy)")
    if tuple(pattern.shape) != (2, PATTERN_POINTS):
        raise ValueError(f"pattern must be (2, {PATTERN_POINTS}), got {tuple(pattern.shape)}")
    if any(t.device != dev for t in (xy, pattern, *per_kp)):
        raise ValueError("xy, angles / trig and pattern must lie on the sampling image's device")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def brief_descriptors(
    sampling_img: torch.Tensor,
    xy: torch.Tensor,
    angles_deg: torch.Tensor,
    trig: tuple[torch.Tensor, torch.Tensor] | None = None,
    pattern: torch.Tensor | None = None,
    fused: bool = False,
) -> torch.Tensor:
    """(N, 32) uint8 descriptors.

    sampling_img: bordered composite from `brief_sampling_image`, or
    (without `fused`) the (N, 37, 37) windows at `brief_window_starts(xy)`
    gathered already; xy: (N, 2) f32 level coords (un-bordered); angles:
    (N,) degrees (not read when `trig` pins (cos, sin)).

    `fused`: one launch of the rBRIEF kernel on a CUDA image, counted in
    `brief_descriptors.launches`; `brief_descriptors_plain` on a CPU
    image."""
    if pattern is None:
        pattern = brief_pattern(sampling_img.device)
    if fused:
        _check_fused(sampling_img, xy, angles_deg, trig, pattern)
        if sampling_img.device.type == "cpu":
            return brief_descriptors_plain(sampling_img, xy, angles_deg, trig, pattern)
        img = sampling_img.contiguous()
        xy = _f32(xy)
        pattern = _f32(pattern)
        if pattern.data_ptr() % 16:
            pattern = pattern.clone()  # the kernel reads its points as 16-byte vectors
        if trig is None:
            per_kp = (_f32(angles_deg), None, None)
        else:
            per_kp = (None, _f32(trig[0]), _f32(trig[1]))
        h, w = img.shape
        k = xy.shape[0]
        out = torch.empty((k, 32), dtype=torch.uint8, device=img.device)
        err = _build.kernels().brief_descriptors(
            img.data_ptr(), h, w, xy.data_ptr(),
            *(None if t is None else t.data_ptr() for t in per_kp),
            pattern.data_ptr(), k, ctypes.c_float(_FACTOR_PI), out.data_ptr(), stream_handle(img),
        )
        brief_descriptors.launches += 1
        _build.check_launch("brief_descriptors", err)
        return out
    ridx, cidx = brief_indices(angles_deg, trig, pattern)
    starts = brief_window_starts(xy) if sampling_img.dim() == 2 else (None, None)
    samples = sample_windows(sampling_img, *starts, ridx, cidx, BRIEF_WINDOW, BRIEF_WINDOW)
    return _pack(samples)


brief_descriptors.launches = 0
