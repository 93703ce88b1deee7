"""Batched window gather (kernel B2) and the two compositions on top of it,
each with its fused kernel (B4, B5).

Counterpart of ``orbslam3_tpu/ops/window_gather.py``.  `gather_windows` is
the wrapper of the hand-written CUDA kernel ``csrc/gather_windows.cu``
(B2, which replaces the TPU kernel ``_gather_windows_pallas``);
`gather_windows_plain` is its plain PyTorch twin (the semantics of
``ops/patches.extract_row_strips``).  Windows come back as uint8 where the
reference returns bf16: the values are equal.

`window_moments` and `sample_windows` run, by default, as the reference's
compositions over `gather_windows` (one B2 launch each on CUDA); with
`fused` they launch ``csrc/window_moments.cu`` (B4, which replaces
``_window_moments_pallas``) and ``csrc/sample_windows.cu`` (B5, which
replaces ``_sample_windows_pallas``) instead, as the reference does under
ORBSLAM3_TPU_PALLAS_MOMENTS=1 / ORBSLAM3_TPU_PALLAS_SAMPLE=1.
`window_moments_plain` and `sample_windows_plain` are the twins: the same
compositions over `gather_windows_plain`, launching no hand-written kernel.
"""

from __future__ import annotations

import torch

from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch._device import stream_handle


def _check_windows(img2d: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor, nr: int, nc: int):
    if img2d.dim() != 2 or img2d.dtype != torch.uint8:
        raise TypeError(f"img2d must be a 2-D uint8 tensor, got {img2d.dtype} {tuple(img2d.shape)}")
    h, w = img2d.shape
    if not (0 < nr <= h and 0 < nc <= w):
        raise ValueError(f"window {nr}x{nc} does not fit a {h}x{w} image")
    if row0.shape != col0.shape or row0.dim() != 1:
        raise ValueError("row0 and col0 must be (K,) vectors of one shape")
    if img2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {img2d.device}")
    if row0.device != img2d.device or col0.device != img2d.device:
        raise ValueError("row0/col0 must lie on the image's device")


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
    _check_windows(img2d, row0, col0, nr, nc)
    if img2d.device.type == "cpu":
        return gather_windows_plain(img2d, row0, col0, nr, nc)
    h, w = img2d.shape
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


def _moments_of(patches: torch.Tensor, weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    m = (patches.to(torch.int32)[:, None] * weights[None]).sum(dim=(2, 3), dtype=torch.int32)
    m = m.to(torch.float32)
    return m[:, 0], m[:, 1]


def window_moments_plain(
    img2d: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor, weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of B4: `gather_windows_plain` + int32 weighted sum."""
    _, nr, nc = weights.shape
    return _moments_of(gather_windows_plain(img2d, row0, col0, nr, nc), weights)


def window_moments(
    img2d: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor, weights: torch.Tensor,
    fused: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(m10, m01) f32 weighted window sums per keypoint.  weights: (2, nr,
    nc) int32.  Summed in int32 (exact), returned as f32 like the
    reference (integers < 2^24 are exact in f32).

    Default: `gather_windows` (B2 on CUDA) + the weighted sum.  `fused`:
    the B4 kernel on a CUDA tensor, the plain twin on a CPU tensor."""
    _, nr, nc = weights.shape
    if not fused:
        return _moments_of(gather_windows(img2d, row0, col0, nr, nc), weights)
    _check_windows(img2d, row0, col0, nr, nc)
    if weights.dim() != 3 or weights.shape[0] != 2 or weights.device != img2d.device:
        raise ValueError("weights must be (2, nr, nc) on the image's device")
    if img2d.device.type == "cpu":
        return window_moments_plain(img2d, row0, col0, weights)
    if 2 * nr * nc * 4 > 48 * 1024:
        raise ValueError(f"B4 stages the weights in shared memory: {nr}x{nc} is too large")
    img2d = img2d.contiguous()
    row0 = row0.to(torch.int32).contiguous()
    col0 = col0.to(torch.int32).contiguous()
    weights = weights.to(torch.int32).contiguous()
    h, w = img2d.shape
    k = row0.shape[0]
    out = torch.empty((k, 2), dtype=torch.float32, device=img2d.device)
    err = _build.kernels().window_moments(
        img2d.data_ptr(), h, w, row0.data_ptr(), col0.data_ptr(), k, nr, nc,
        weights.data_ptr(), out.data_ptr(), stream_handle(img2d),
    )
    window_moments.launches += 1
    _build.check_launch("window_moments", err)
    return out[:, 0], out[:, 1]


window_moments.launches = 0


def _samples_of(patches: torch.Tensor, ridx: torch.Tensor, cidx: torch.Tensor) -> torch.Tensor:
    k, nr, nc = patches.shape
    flat = ridx.to(torch.int64) * nc + cidx.to(torch.int64)
    return patches.reshape(k, nr * nc).gather(1, flat)


def sample_windows_plain(
    img2d: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor,
    ridx: torch.Tensor, cidx: torch.Tensor, nr: int, nc: int,
) -> torch.Tensor:
    """Plain PyTorch twin of B5: `gather_windows_plain` + per-sample pick."""
    return _samples_of(gather_windows_plain(img2d, row0, col0, nr, nc), ridx, cidx)


def sample_windows(
    img2d: torch.Tensor,
    row0: torch.Tensor,
    col0: torch.Tensor,
    ridx: torch.Tensor,
    cidx: torch.Tensor,
    nr: int,
    nc: int,
    fused: bool = False,
) -> torch.Tensor:
    """(K, S) uint8 samples; sample [k, s] = img2d[row0'[k] + ridx[k, s],
    col0'[k] + cidx[k, s]] with the window starts clamped as in
    `gather_windows`.  ridx/cidx must lie in [0, nr) / [0, nc).

    Default: `gather_windows` (B2 on CUDA) + the pick.  `fused`: the B5
    kernel on a CUDA tensor, the plain twin on a CPU tensor."""
    if not fused:
        return _samples_of(gather_windows(img2d, row0, col0, nr, nc), ridx, cidx)
    _check_windows(img2d, row0, col0, nr, nc)
    if ridx.dim() != 2 or ridx.shape != cidx.shape or ridx.shape[0] != row0.shape[0]:
        raise ValueError("ridx and cidx must be (K, S) with K keypoints")
    if ridx.device != img2d.device or cidx.device != img2d.device:
        raise ValueError("ridx/cidx must lie on the image's device")
    if img2d.device.type == "cpu":
        return sample_windows_plain(img2d, row0, col0, ridx, cidx, nr, nc)
    if nr * nc > 48 * 1024:
        raise ValueError(f"B5 stages the window in shared memory: {nr}x{nc} is too large")
    img2d = img2d.contiguous()
    row0 = row0.to(torch.int32).contiguous()
    col0 = col0.to(torch.int32).contiguous()
    ridx = ridx.to(torch.int32).contiguous()
    cidx = cidx.to(torch.int32).contiguous()
    h, w = img2d.shape
    k, s = ridx.shape
    out = torch.empty((k, s), dtype=torch.uint8, device=img2d.device)
    err = _build.kernels().sample_windows(
        img2d.data_ptr(), h, w, row0.data_ptr(), col0.data_ptr(), ridx.data_ptr(),
        cidx.data_ptr(), k, s, nr, nc, out.data_ptr(), stream_handle(img2d),
    )
    sample_windows.launches += 1
    _build.check_launch("sample_windows", err)
    return out


sample_windows.launches = 0
