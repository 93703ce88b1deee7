"""Spatially-uniform top-K keypoint selection.

Counterpart of ``orbslam3_tpu/ops/select.py`` (cell winners first, then the
best residuals of a 2x finer grid).  The candidate pools of every map of
one `select_topk_grid_multi` call come from the hand-written CUDA kernel
``csrc/grid_pool.cu`` (K1: two launches, coarse cells then fine cells and
pads, on a CUDA tensor; `candidate_pools`) or, on a CPU tensor, from its
plain twin `candidate_pools_plain`, the per-map torch ops of
`_candidate_pool`.  The reference's `lax.top_k` takes the lower index
first among equal keys, and keys tie often (integer responses plus a 1e6
winner offset); `torch.topk` promises no order among ties, so the port
sorts with `stable=True`, which keeps the lower index first (C-h1): the
sort and the gathers after it stay torch ops, as the reference's top_k
runs outside any Pallas kernel.  The reference's byte-split one-hot
payload pickup is a plain gather here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch._device import stream_handle

# maps one pair of K1 launches takes (kMaxMaps of csrc/grid_pool.cu)
MAX_MAPS = 32


def cell_size_for(h: int, w: int, k: int) -> int:
    """Smallest cell size whose grid has at most k cells."""
    cell = max(int(math.sqrt(h * w / max(k, 1))), 1)
    while math.ceil(w / cell) * math.ceil(h / cell) > k:
        cell += 1
    return cell


def _grid_maxima(m: torch.Tensor, c: int):
    """Per-cell (max, y, x) for cell size c over m (h, w multiples of c).

    Score and within-cell position pack into one int32 so a single max
    finds both; packing (cc-1-local) breaks ties by the smallest
    within-cell flat index, as the reference does."""
    mh, mw = m.shape
    ny, nx = mh // c, mw // c
    cc = c * c
    dev = m.device
    ys = torch.arange(mh, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(mw, dtype=torch.int32, device=dev)[None, :]
    local = (ys % c) * c + (xs % c)
    packed = m.to(torch.int32) * cc + (cc - 1 - local)
    pmax = packed.view(ny, c, nx, c).amax(dim=(1, 3))
    cmax = pmax // cc
    l_win = (cc - 1) - pmax % cc
    by = torch.arange(ny, dtype=torch.int32, device=dev)[:, None] * c
    bx = torch.arange(nx, dtype=torch.int32, device=dev)[None, :] * c
    cy = by + l_win // c
    cx = bx + l_win % c
    return cmax.reshape(-1), cy.reshape(-1), cx.reshape(-1), packed, pmax


def _pad_to(a: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return torch.nn.functional.pad(a, (0, w - a.shape[1], 0, h - a.shape[0]))


def _candidate_pool(score: torch.Tensor, k: int):
    """(key, resp, ys, xs) flat candidate pool for one NMS'd score map.

    key: f32 sort key (winners above residuals above invalid); the pool
    holds >= k entries."""
    h, w = score.shape
    cell = cell_size_for(h, w, k)
    gy, gx = math.ceil(h / cell), math.ceil(w / cell)
    ph, pw = gy * cell, gx * cell
    padded = _pad_to(score.to(torch.int32), ph, pw)
    cmax, wy, wx, packed, pmax = _grid_maxima(padded, cell)

    # residual pool: cell winners suppressed, then best per 2x-finer cell
    pmax_full = pmax.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
    resid = torch.where(packed == pmax_full, 0, padded)
    fine = max(cell // 2, 1)
    fy, fx = math.ceil(ph / fine), math.ceil(pw / fine)
    resid = _pad_to(resid, fy * fine, fx * fine)
    rresp, ry, rx, _, _ = _grid_maxima(resid, fine)

    zpad = torch.zeros(k, dtype=torch.int32, device=score.device)
    resp = torch.cat([cmax, rresp, zpad])
    ys = torch.cat([wy, ry, zpad])
    xs = torch.cat([wx, rx, zpad])
    is_winner = torch.cat(
        [torch.ones_like(cmax), torch.zeros_like(rresp), zpad]
    ).to(torch.float32)
    key = torch.where(resp > 0, is_winner * 1e6 + resp.to(torch.float32), -1.0)
    return key, resp, ys, xs


def _grid_of(h: int, w: int, k: int) -> tuple[int, int, int]:
    """(cell, fine, coarse + fine cells) of one map's pool."""
    cell = cell_size_for(h, w, k)
    gy, gx = math.ceil(h / cell), math.ceil(w / cell)
    fine = max(cell // 2, 1)
    return cell, fine, gy * gx + math.ceil(gy * cell / fine) * math.ceil(gx * cell / fine)


def candidate_pools_plain(scores: list, ks: list):
    """Plain twin of K1: (key, resp, ys, xs), each (L, P), row l the pool of
    `_candidate_pool(scores[l], ks[l])` padded to the longest pool P (key
    -1, the others 0)."""
    pools = [_candidate_pool(s, k) for s, k in zip(scores, ks)]
    pmax = max(p[0].shape[0] for p in pools)

    def stack(i, fill):
        return torch.stack(
            [torch.nn.functional.pad(p[i], (0, pmax - p[i].shape[0]), value=fill) for p in pools]
        )

    return stack(0, -1.0), stack(1, 0), stack(2, 0), stack(3, 0)


def candidate_pools(scores: list, ks: list):
    """(key, resp, ys, xs), each (L, P), equal to `candidate_pools_plain`.
    CUDA tensors: the two launches of K1 for every MAX_MAPS maps (one pair
    for any selection of the port's paths), each launch counted; CPU
    tensors: the plain twin."""
    if not scores or len(scores) != len(ks):
        raise ValueError("one quota per score map, at least one map")
    dev = scores[0].device
    if any(s.dim() != 2 or s.device != dev or 0 in s.shape for s in scores):
        raise ValueError("score maps must be non-empty 2-D tensors on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu":
        return candidate_pools_plain(scores, ks)
    grids = [_grid_of(*s.shape, k) for s, k in zip(scores, ks)]
    pool = max(n + k for (_, _, n), k in zip(grids, ks))
    params, maps = [], []
    for s, (cell, fine, _) in zip(scores, grids):
        s = s.to(torch.int32)
        if s.stride(1) != 1:
            s = s.contiguous()
        maps.append(s)  # alive until the launches are queued
        params.append([s.data_ptr(), s.shape[0], s.shape[1], s.stride(0), cell, fine])
    n = len(scores)
    key = torch.empty((n, pool), dtype=torch.float32, device=dev)
    resp, ys, xs = (torch.empty((n, pool), dtype=torch.int32, device=dev) for _ in range(3))
    for l0 in range(0, n, MAX_MAPS):
        chunk = [v for p in params[l0 : l0 + MAX_MAPS] for v in p]
        err = _build.kernels().grid_pool(
            (ctypes.c_longlong * len(chunk))(*chunk), len(chunk) // 6,
            *(t[l0].data_ptr() for t in (key, resp, ys, xs)), pool, stream_handle(maps[0]),
        )
        candidate_pools.launches += 2
        _build.check_launch("grid_pool", err)
    return key, resp, ys, xs


candidate_pools.launches = 0


def select_topk_grid_multi(scores: list, ks: list) -> list:
    """Grid top-K for SEVERAL maps with ONE batched stable sort.

    Row l's first ks[l] entries equal what a single-map selection returns.
    Returns a list of (xy (k, 2) int32 crop coords, resp (k,) int32,
    valid (k,) bool)."""
    if len(scores) != len(ks):
        raise ValueError("one quota per score map")
    if not scores:
        return []
    key, resp, ys, xs = candidate_pools(scores, ks)  # (L, P)
    kmax = max(ks)
    top_key, sel = torch.sort(key, dim=1, descending=True, stable=True)
    top_key, sel = top_key[:, :kmax], sel[:, :kmax]
    r = resp.gather(1, sel)
    y = ys.gather(1, sel)
    x = xs.gather(1, sel)
    return [
        (torch.stack([x[l, :k], y[l, :k]], dim=1), r[l, :k], top_key[l, :k] > 0)
        for l, k in enumerate(ks)
    ]
