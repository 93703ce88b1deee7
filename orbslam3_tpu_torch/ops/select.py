"""Spatially-uniform top-K keypoint selection.

Counterpart of ``orbslam3_tpu/ops/select.py`` (cell winners first, then the
best residuals of a 2x finer grid).  The reference's `lax.top_k` takes the
lower index first among equal keys, and keys tie often (integer responses
plus a 1e6 winner offset); `torch.topk` promises no order among ties, so
the port sorts with `stable=True`, which keeps the lower index first (C-h1).
The reference's byte-split one-hot payload pickup is a plain gather here.
"""

from __future__ import annotations

import math

import torch


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


def select_topk_grid_multi(scores: list, ks: list) -> list:
    """Grid top-K for SEVERAL maps with ONE batched stable sort.

    Row l's first ks[l] entries equal what a single-map selection returns.
    Returns a list of (xy (k, 2) int32 crop coords, resp (k,) int32,
    valid (k,) bool)."""
    if len(scores) != len(ks):
        raise ValueError("one quota per score map")
    if not scores:
        return []
    pools = [_candidate_pool(s, k) for s, k in zip(scores, ks)]
    pmax = max(p[0].shape[0] for p in pools)
    kmax = max(ks)

    def stack(i, fill):
        return torch.stack(
            [torch.nn.functional.pad(p[i], (0, pmax - p[i].shape[0]), value=fill) for p in pools]
        )

    key = stack(0, -1.0)  # (L, P)
    resp, ys, xs = stack(1, 0), stack(2, 0), stack(3, 0)
    top_key, sel = torch.sort(key, dim=1, descending=True, stable=True)
    top_key, sel = top_key[:, :kmax], sel[:, :kmax]
    r = resp.gather(1, sel)
    y = ys.gather(1, sel)
    x = xs.gather(1, sel)
    return [
        (torch.stack([x[l, :k], y[l, :k]], dim=1), r[l, :k], top_key[l, :k] > 0)
        for l, k in enumerate(ks)
    ]
