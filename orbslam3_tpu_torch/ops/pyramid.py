"""Image pyramid: cv2 INTER_LINEAR u8 resize + fixed-point Gaussian blur.

Counterpart of ``orbslam3_tpu/ops/pyramid.py``.  The reference evaluates
the integer arithmetic as bf16/f32 matmuls with hi/lo splits so the TPU's
matrix unit can run it; here it is what it always meant: int32 gathers,
multiplies and shifts, exact on any device (no TF32 question, C-h3).
Every tap comes from the JAX package's own numpy tables (`_linear_coeffs`,
`gaussian_kernel7_fixed`), so both packages compute from identical numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch.oracle.orb_cpu import (
    PyramidParams,
    _linear_coeffs,
    gaussian_kernel7_fixed,
)

BLUR_HALF = 1 << 15
BLUR_SHIFT = 16


class ResizeTaps(NamedTuple):
    """Resize taps of every level > 0, concatenated across levels.

    Horizontal: source columns `sx`/`sx1` with 11-bit taps `ax0`/`ax1`, one
    entry per destination column (sum of level widths).  Vertical: source
    rows `sy`/`sy1` with taps `by0`/`by1` (sum of level heights).  All int32
    (int64 for the index vectors)."""

    sx: torch.Tensor
    sx1: torch.Tensor
    ax0: torch.Tensor
    ax1: torch.Tensor
    sy: torch.Tensor
    sy1: torch.Tensor
    by0: torch.Tensor
    by1: torch.Tensor


def resize_taps_np(sh: int, sw: int, sizes) -> dict[str, np.ndarray]:
    """Numpy resize taps for destination `sizes` [(dh, dw), ...] of a
    (sh, sw) source, concatenated in level order."""
    sx, ax0, ax1 = (np.concatenate(p) for p in zip(*[_linear_coeffs(dw, sw) for _, dw in sizes]))
    sy, by0, by1 = (np.concatenate(p) for p in zip(*[_linear_coeffs(dh, sh) for dh, _ in sizes]))
    return dict(
        sx=sx.astype(np.int64),
        sx1=np.minimum(sx + 1, sw - 1).astype(np.int64),
        ax0=ax0.astype(np.int32),
        ax1=ax1.astype(np.int32),
        sy=sy.astype(np.int64),
        sy1=np.minimum(sy + 1, sh - 1).astype(np.int64),
        by0=by0.astype(np.int32),
        by1=by1.astype(np.int32),
    )


def resize_taps(sh: int, sw: int, sizes, device) -> ResizeTaps:
    t = resize_taps_np(sh, sw, sizes)
    return ResizeTaps(**{k: torch.from_numpy(v).to(device) for k, v in t.items()})


def blur_taps(device) -> torch.Tensor:
    """(7,) int32 fixed-point Gaussian taps summing to 2**16."""
    return torch.from_numpy(gaussian_kernel7_fixed().astype(np.int32)).to(device)


def _horizontal(src: torch.Tensor, taps: ResizeTaps) -> torch.Tensor:
    """(sh, sum_w) int32 horizontal accumulator >> 4 (<= 32640)."""
    s = src.to(torch.int32)
    rows = s[:, taps.sx] * taps.ax0 + s[:, taps.sx1] * taps.ax1
    return rows >> 4


def _vertical(r: torch.Tensor, sy, sy1, by0, by1) -> torch.Tensor:
    """cv2's vertical pass: ((by0*r0) >> 16) + ((by1*r1) >> 16) + 2 >> 2."""
    out = ((by0[:, None] * r[sy]) >> 16) + ((by1[:, None] * r[sy1]) >> 16) + 2
    return (out >> 2).clamp(0, 255).to(torch.uint8)


def resize_linear_u8(src: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """Bit-exact cv2 INTER_LINEAR 8u resize (11-bit taps, 22-bit accumulator)."""
    sh, sw = src.shape
    taps = resize_taps(sh, sw, [(dh, dw)], src.device)
    return _vertical(_horizontal(src, taps), taps.sy, taps.sy1, taps.by0, taps.by1)


def build_pyramid(
    image: torch.Tensor, params: PyramidParams, taps: ResizeTaps | None = None
) -> list[torch.Tensor]:
    """All pyramid levels (uint8); level l is a bit-exact cv2 INTER_LINEAR
    resize of the native image.  The horizontal pass is shared by every
    level (all read the same source rows); `taps` defaults to the JAX
    package's tables on `image`'s device."""
    sh, sw = image.shape
    sizes = params.level_sizes(sh, sw)[1:]
    if not sizes:
        return [image]
    if taps is None:
        taps = resize_taps(sh, sw, sizes, image.device)
    rows = _horizontal(image, taps)  # (sh, sum_w)
    levels = [image]
    y = x = 0
    for dh, dw in sizes:
        r = rows[:, x : x + dw]
        levels.append(
            _vertical(
                r,
                taps.sy[y : y + dh], taps.sy1[y : y + dh],
                taps.by0[y : y + dh], taps.by1[y : y + dh],
            )
        )
        y += dh
        x += dw
    return levels


def reflect101_index(n: int, p: int, device) -> torch.Tensor:
    """Source indices of an axis of length n padded by p on each side with
    reflect-101 (no edge repeat), as numpy's / cv2's 'reflect'."""
    i = torch.arange(-p, n + p, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def reflect101_pad(img: torch.Tensor, p: int) -> torch.Tensor:
    h, w = img.shape
    ri = reflect101_index(h, p, img.device)
    ci = reflect101_index(w, p, img.device)
    return img[ri][:, ci]


def gaussian_blur7_u8(
    img: torch.Tensor, reflect: bool = True, taps: torch.Tensor | None = None
) -> torch.Tensor:
    """Separable 7-tap sigma=2 fixed-point blur, bit-exact vs the oracle.

    int32 throughout: every partial sum is <= 255 * 65536 < 2^31.  The
    horizontal pass rounds (+2^15 >> 16) before the vertical one, which
    rounds again.  `reflect=False` zero-pads instead of reflect-101 — valid
    only where outputs within 3 px of the edge are never consumed (the
    merged composite masks them out)."""
    h, w = img.shape
    if taps is None:
        taps = blur_taps(img.device)
    x = img.to(torch.int32)
    pad = reflect101_pad(x, 3) if reflect else torch.nn.functional.pad(x, (3, 3, 3, 3))
    hp = sum(taps[i] * pad[:, i : i + w] for i in range(7))
    hp = (hp + BLUR_HALF) >> BLUR_SHIFT
    vp = sum(taps[i] * hp[i : i + h, :] for i in range(7))
    out = (vp + BLUR_HALF) >> BLUR_SHIFT
    return out.clamp(0, 255).to(torch.uint8)
