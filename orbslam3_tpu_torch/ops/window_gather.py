"""Batched window gather (kernel B2) and the two compositions on top of it.

Counterpart of ``orbslam3_tpu/ops/window_gather.py``.  `gather_windows` is
the wrapper of the hand-written CUDA kernel ``csrc/gather_windows.cu``
(B2, which replaces the TPU kernel ``_gather_windows_pallas``);
`gather_windows_plain` is its plain PyTorch twin (the semantics of
``ops/patches.extract_row_strips``).  Windows come back as uint8 where the
reference returns bf16: the values are equal.
"""

from __future__ import annotations

import torch

from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch._device import stream_handle


def gather_windows_plain(
    img2d: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor, nr: int, nc: int
) -> torch.Tensor:
    """Plain PyTorch twin of B2: (K, nr, nc) windows, starts clamped."""
    h, w = img2d.shape
    r = row0.to(torch.int64).clamp(0, h - nr)
    c = col0.to(torch.int64).clamp(0, w - nc)
    rows = r[:, None] + torch.arange(nr, device=img2d.device)
    cols = c[:, None] + torch.arange(nc, device=img2d.device)
    return img2d[rows[:, :, None], cols[:, None, :]]


def gather_windows(
    img2d: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor, nr: int, nc: int
) -> torch.Tensor:
    """(K, nr, nc) uint8 windows; window k = img2d[row0[k]:+nr, col0[k]:+nc].

    Starts are clamped into bounds (callers guarantee real windows are
    in-bounds; clamping only normalises masked/invalid slots).
    CUDA tensor: launches the B2 kernel.  CPU tensor: the plain twin."""
    if img2d.dim() != 2 or img2d.dtype != torch.uint8:
        raise TypeError(f"img2d must be a 2-D uint8 tensor, got {img2d.dtype} {tuple(img2d.shape)}")
    h, w = img2d.shape
    if not (0 < nr <= h and 0 < nc <= w):
        raise ValueError(f"window {nr}x{nc} does not fit a {h}x{w} image")
    if row0.shape != col0.shape or row0.dim() != 1:
        raise ValueError("row0 and col0 must be (K,) vectors of one shape")
    if img2d.device.type == "cpu":
        return gather_windows_plain(img2d, row0, col0, nr, nc)
    if img2d.device.type != "cuda":
        raise ValueError(f"gather_windows: unsupported device {img2d.device}")
    if row0.device != img2d.device or col0.device != img2d.device:
        raise ValueError("row0/col0 must lie on the image's device")
    img2d = img2d.contiguous()
    row0 = row0.to(torch.int32).contiguous()
    col0 = col0.to(torch.int32).contiguous()
    k = row0.shape[0]
    out = torch.empty((k, nr, nc), dtype=torch.uint8, device=img2d.device)
    err = _build.kernels().gather_windows(
        img2d.data_ptr(), h, w, row0.data_ptr(), col0.data_ptr(), k, nr, nc,
        out.data_ptr(), stream_handle(img2d),
    )
    gather_windows.launches += 1
    _build.check_launch("gather_windows", err)
    return out


gather_windows.launches = 0


def window_moments(
    img2d: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor, weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(m10, m01) f32 weighted window sums per keypoint.  weights: (2, nr,
    nc) int32.  Summed in int32 (exact), returned as f32 like the
    reference (integers < 2^24 are exact in f32)."""
    _, nr, nc = weights.shape
    patches = gather_windows(img2d, row0, col0, nr, nc).to(torch.int32)
    m = (patches[:, None] * weights[None]).sum(dim=(2, 3), dtype=torch.int32)
    m = m.to(torch.float32)
    return m[:, 0], m[:, 1]


def sample_windows(
    img2d: torch.Tensor,
    row0: torch.Tensor,
    col0: torch.Tensor,
    ridx: torch.Tensor,
    cidx: torch.Tensor,
    nr: int,
    nc: int,
) -> torch.Tensor:
    """(K, S) uint8 samples; sample [k, s] = img2d[row0'[k] + ridx[k, s],
    col0'[k] + cidx[k, s]] with the window starts clamped as in
    `gather_windows`.  ridx/cidx must lie in [0, nr) / [0, nc)."""
    patches = gather_windows(img2d, row0, col0, nr, nc)
    flat = (ridx.to(torch.int64) * nc + cidx.to(torch.int64))
    return patches.reshape(patches.shape[0], nr * nc).gather(1, flat)
