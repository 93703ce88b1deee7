"""Rotated-BRIEF (rBRIEF) 256-bit descriptors.

Counterpart of ``orbslam3_tpu/ops/brief.py``: rotate the 512 pattern points
in f32 with the reference's expression order, round half to even
(`torch.round`, as `jnp.rint`, C-h4), sample the 37x37 window around each
keypoint (indexing into B2 windows, or the fused B5 kernel with
`fused`), compare the 256 pairs and pack bits LSB-first per byte (even
samples < odd samples).  The windows may come gathered already
(`brief_window_starts` gives their starts: they do not depend on the
angles), so that one B2 launch serves orientation and rBRIEF.  Bit-exact
given the same (cos, sin); pass `trig` to pin them, since platform trig
may differ by ulps (C-h2).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from orbslam3_tpu_torch.ops.brief_pattern import BIT_PATTERN_31
from orbslam3_tpu_torch.ops.pyramid import reflect101_pad
from orbslam3_tpu_torch.ops.window_gather import sample_windows

BRIEF_PAD = 19   # border width of the sampling buffer (reference EDGE_THRESHOLD)
PATCH_HALF = 18  # max rounded rotated pattern offset
BRIEF_WINDOW = 2 * PATCH_HALF + 1

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
    (N,) degrees."""
    if pattern is None:
        pattern = brief_pattern(sampling_img.device)
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
    starts = brief_window_starts(xy) if sampling_img.dim() == 2 else (None, None)
    samples = sample_windows(
        sampling_img, *starts, r_off + PATCH_HALF, c_off + PATCH_HALF,
        BRIEF_WINDOW, BRIEF_WINDOW, fused=fused,
    )
    bits = (samples[:, 0::2] < samples[:, 1::2]).to(torch.int32).reshape(-1, 32, 8)
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    return (bits << shifts).sum(dim=-1, dtype=torch.int32).to(torch.uint8)
