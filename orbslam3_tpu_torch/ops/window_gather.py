"""Batched window gather (kernel B2) and the two compositions on top of it,
each with its fused kernel (B4, B5).

Counterpart of ``orbslam3_tpu/ops/window_gather.py``.  `gather_windows_many`
is the wrapper of the hand-written CUDA kernel ``csrc/gather_windows.cu``
(B2, which replaces the TPU kernel ``_gather_windows_pallas``): one launch
gathers the windows of up to two jobs that share K, and a stereo frame
makes two B2 launches (orientation + BRIEF windows, left + right SAD
strips);
`gather_windows` is its one-job call.  `gather_windows_plain` is the plain
PyTorch twin (the semantics of ``ops/patches.extract_row_strips``).
Windows come back as uint8 where the reference returns bf16: the values
are equal.

`window_moments` and `sample_windows` run, by default, as the reference's
compositions over B2 windows: gathered by the caller, or by one
`gather_windows` call of their own; with `fused` they launch
``csrc/window_moments.cu`` (B4, which replaces ``_window_moments_pallas``)
and the index mode of ``csrc/sample_windows.cu`` (B5, which replaces
``_sample_windows_pallas``) instead, as the reference does under
ORBSLAM3_TPU_PALLAS_MOMENTS=1 / ORBSLAM3_TPU_PALLAS_SAMPLE=1.  (The
front-end's fused rBRIEF takes B5's other mode, `ops/brief.brief_descriptors`,
which needs no index planes.)
`window_moments_plain` and `sample_windows_plain` are the twins: the same
compositions over `gather_windows_plain`, launching no hand-written kernel.
"""

from __future__ import annotations

import ctypes

import torch

from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch._device import stream_handle


# jobs one B2 launch takes, and output bytes of one job, at most
# (kMaxJobs and kMaxTotal of csrc/gather_windows.cu)
MAX_JOBS = 2
MAX_OUTPUT_BYTES = 2**31 - 2**16


def _check_windows(img2d: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor, nr: int, nc: int):
    if img2d.dim() != 2 or img2d.dtype != torch.uint8:
        raise TypeError(f"img2d must be a 2-D uint8 tensor, got {img2d.dtype} {tuple(img2d.shape)}")
    h, w = img2d.shape
    if not (0 < nr <= h and 0 < nc <= w):
        raise ValueError(f"window {nr}x{nc} does not fit a {h}x{w} image")
    if h * w >= 2**31:
        raise ValueError(f"a {h}x{w} image has 2^31 pixels or more")
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


def gather_windows_many(jobs) -> list[torch.Tensor]:
    """One (K, nr, nc) uint8 tensor per job (img2d, row0, col0, nr, nc),
    each equal to `gather_windows_plain` of that job.  The jobs share K and
    a device, nothing else.  CUDA tensors: one launch of the B2 kernel for
    every job, counted once.  CPU tensors: the plain twin per job."""
    jobs = list(jobs)
    if not jobs:
        return []
    if len(jobs) > MAX_JOBS:
        raise ValueError(f"{len(jobs)} jobs: one B2 launch takes at most {MAX_JOBS}")
    dev = jobs[0][0].device
    k = jobs[0][1].shape[0]
    if any(job[0].device != dev for job in jobs):
        raise ValueError("the jobs of one launch must lie on one device")
    if any(job[1].shape[0] != k for job in jobs):
        raise ValueError("the jobs of one launch must share K")
    for job in jobs:
        _check_windows(*job)
    if any(k * nr * nc > MAX_OUTPUT_BYTES for *_, nr, nc in jobs):
        raise ValueError(f"a job's output exceeds {MAX_OUTPUT_BYTES} bytes")
    if dev.type == "cpu":
        return [gather_windows_plain(*job) for job in jobs]
    params, outs, inputs = [], [], []
    for img2d, row0, col0, nr, nc in jobs:
        h, w = img2d.shape
        img2d = img2d.contiguous()
        row0 = row0.to(torch.int32).contiguous()
        col0 = col0.to(torch.int32).contiguous()
        out = torch.empty((k, nr, nc), dtype=torch.uint8, device=dev)
        inputs += [img2d, row0, col0]  # alive until the launch is queued
        params += [img2d.data_ptr(), h, w, row0.data_ptr(), col0.data_ptr(), nr, nc, out.data_ptr()]
        outs.append(out)
    if k == 0:
        return outs
    err = _build.kernels().gather_windows(
        (ctypes.c_longlong * len(params))(*params), len(jobs), k, stream_handle(inputs[0]),
    )
    gather_windows.launches += 1
    _build.check_launch("gather_windows", err)
    return outs


def gather_windows(
    img2d: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor, nr: int, nc: int
) -> torch.Tensor:
    """(K, nr, nc) uint8 windows; window k = img2d[row0[k]:+nr, col0[k]:+nc].

    Starts are clamped into bounds (callers guarantee real windows are
    in-bounds; clamping only normalises masked/invalid slots).
    The one-job call of `gather_windows_many`: on a CUDA tensor one B2
    launch, on a CPU tensor the plain twin."""
    return gather_windows_many([(img2d, row0, col0, nr, nc)])[0]


gather_windows.launches = 0


def _windows_at(
    src: torch.Tensor, row0: torch.Tensor | None, col0: torch.Tensor | None, nr: int, nc: int
) -> torch.Tensor:
    """The (K, nr, nc) windows at the starts: `src` itself where the caller
    gathered them already (a 3-D block, say from a `gather_windows_many`
    launch shared with another gather; the starts may then be None), else
    one `gather_windows` call on the image `src`."""
    if src.dim() != 3:
        return gather_windows(src, row0, col0, nr, nc)
    if (
        tuple(src.shape[1:]) != (nr, nc) or src.dtype != torch.uint8
        or (row0 is not None and row0.shape[0] != src.shape[0])
    ):
        raise ValueError(
            f"windows gathered already must be (K, {nr}, {nc}) uint8 with K starts, "
            f"got {src.dtype} {tuple(src.shape)}"
        )
    return src


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
    img2d: torch.Tensor, row0: torch.Tensor | None, col0: torch.Tensor | None,
    weights: torch.Tensor, fused: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(m10, m01) f32 weighted window sums per keypoint.  weights: (2, nr,
    nc) int32.  Summed in int32 (exact), returned as f32 like the
    reference (integers < 2^24 are exact in f32).

    Default: the weighted sum of B2 windows: `img2d` may be the (K, nr,
    nc) windows at these starts, gathered already (row0 and col0 may then
    be None), else one `gather_windows` call gathers them.  `fused`: the
    B4 kernel on a CUDA image, the plain twin on a CPU image."""
    _, nr, nc = weights.shape
    if not fused:
        return _moments_of(_windows_at(img2d, row0, col0, nr, nc), weights)
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
    row0: torch.Tensor | None,
    col0: torch.Tensor | None,
    ridx: torch.Tensor,
    cidx: torch.Tensor,
    nr: int,
    nc: int,
    fused: bool = False,
) -> torch.Tensor:
    """(K, S) uint8 samples; sample [k, s] = img2d[row0'[k] + ridx[k, s],
    col0'[k] + cidx[k, s]] with the window starts clamped as in
    `gather_windows`.  ridx/cidx must lie in [0, nr) / [0, nc).

    Default: the pick out of B2 windows: `img2d` may be the (K, nr, nc)
    windows at these starts, gathered already (row0 and col0 may then be
    None), else one `gather_windows` call gathers them.  `fused`: the B5
    kernel's index mode on a CUDA image, the plain twin on a CPU image."""
    if not fused:
        return _samples_of(_windows_at(img2d, row0, col0, nr, nc), ridx, cidx)
    _check_windows(img2d, row0, col0, nr, nc)
    if ridx.dim() != 2 or ridx.shape != cidx.shape or ridx.shape[0] != row0.shape[0]:
        raise ValueError("ridx and cidx must be (K, S) with K keypoints")
    if ridx.device != img2d.device or cidx.device != img2d.device:
        raise ValueError("ridx/cidx must lie on the image's device")
    if img2d.device.type == "cpu":
        return sample_windows_plain(img2d, row0, col0, ridx, cidx, nr, nc)
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
