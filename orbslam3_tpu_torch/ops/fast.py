"""FAST-9/16 detection: score kernel (B1), two-threshold retry, strict NMS.

Counterpart of ``orbslam3_tpu/ops/fast.py``.  `raw_score_map` is the
wrapper of the hand-written CUDA kernel ``csrc/fast_score.cu`` (B1, which
replaces the TPU kernel ``_raw_score_pallas``); `raw_score_map_plain` is
its plain PyTorch twin.  On the default path the per-32x32-tile retry and
the 3x3 NMS run as plain tensor code, as in the reference's unfused path.
`detect_fused` is the wrapper of ``csrc/detect_fused.cu`` (B3, which
replaces ``_detect_fused_pallas``): score, retry and NMS in one call;
`detect_fused_plain` is its twin.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch.oracle.orb_cpu import FAST_RING
from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch._device import stream_handle

TILE = 32  # two-threshold retry granularity (work-group tile in the reference)


def check_mask_np(mask_np: np.ndarray, shape) -> None:
    """The mask replaces the 3-px frame test, so a True pixel near the edge
    would score against padding: every True pixel must be >= 3 px inside.
    Checked in numpy, where a layout makes its mask, as the reference
    checks it at trace time."""
    if mask_np.shape != tuple(shape) or mask_np.dtype != np.bool_:
        raise ValueError(f"mask must be bool of shape {tuple(shape)}")
    if (
        mask_np[:3].any() or mask_np[-3:].any()
        or mask_np[:, :3].any() or mask_np[:, -3:].any()
    ):
        raise ValueError(
            "mask contract: every True pixel must be >= 3 px inside the image"
        )


def raw_score_map_plain(img: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch twin of the B1 kernel: (h, w) int32 threshold-free
    FAST score, zero outside the 3-px frame (or outside `mask`)."""
    h, w = img.shape
    c = img.to(torch.int32)
    pad = torch.nn.functional.pad(c, (3, 3, 3, 3))
    ring = torch.stack(
        [pad[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dx, dy in FAST_RING.tolist()]
    )
    d = ring - c[None]  # (16, h, w)

    def arc_min(v):
        m2 = torch.minimum(v, torch.roll(v, -1, 0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, 0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, 0))
        return torch.minimum(m8, torch.roll(v, -8, 0)).amax(0)

    score = torch.maximum(arc_min(d), arc_min(-d)) - 1
    if mask is None:
        mask = torch.zeros((h, w), dtype=torch.bool, device=img.device)
        mask[3 : h - 3, 3 : w - 3] = True
    return torch.where(mask, score, 0)


def raw_score_map(img: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Threshold-free FAST score map (the max threshold at which each pixel
    is a corner), int32, zero outside the 3-px frame or outside `mask`.

    CUDA tensor: launches the B1 kernel.  CPU tensor: the plain twin.  A
    CPU mask is held to the contract here; a CUDA mask must come from a
    layout that checked it in numpy (`detection_layout`), since reading
    its border back would make the host wait for the card at every call."""
    if img.dim() != 2 or img.dtype != torch.uint8:
        raise TypeError(f"img must be a 2-D uint8 tensor, got {img.dtype} {tuple(img.shape)}")
    if mask is not None:
        if tuple(mask.shape) != tuple(img.shape) or mask.dtype != torch.bool:
            raise ValueError(f"mask must be bool of shape {tuple(img.shape)}")
        if mask.device != img.device:
            raise ValueError("mask must lie on the image's device")
    if img.device.type == "cpu":
        if mask is not None:
            check_mask_np(mask.numpy(), img.shape)
        return raw_score_map_plain(img, mask)
    if img.device.type != "cuda":
        raise ValueError(f"raw_score_map: unsupported device {img.device}")
    img = img.contiguous()
    mask = None if mask is None else mask.contiguous()
    h, w = img.shape
    out = torch.empty((h, w), dtype=torch.int32, device=img.device)
    err = _build.kernels().fast_score(
        img.data_ptr(), mask.data_ptr() if mask is not None else None,
        out.data_ptr(), h, w, stream_handle(img),
    )
    raw_score_map.launches += 1
    _build.check_launch("fast_score", err)
    return out


raw_score_map.launches = 0


def nms3(score: torch.Tensor) -> torch.Tensor:
    """Strict 3x3 non-max suppression (kernel `isMax` semantics)."""
    h, w = score.shape
    p = torch.nn.functional.pad(score, (1, 1, 1, 1))
    keep = score > 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                keep &= score > p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
    return torch.where(keep, score, 0)


def shelf_pack(heights, widths, w_comp: int, order=None) -> tuple[list, list]:
    """First-fit 2-D shelf packing, as ``orbslam3_tpu.ops.fast.shelf_pack``
    (carried here because that module imports JAX).

    Blocks are placed in `order` onto shelves of width `w_comp`: the first
    shelf tall and roomy enough takes the block at its x-cursor, else a new
    shelf opens at the bottom.  Returns (place, shelves): place[b] = (y0, x0)
    in the blocks' original indexing, shelves rows [y0, height, x_cursor]."""
    n = len(heights)
    if order is None:
        order = range(n)
    shelves: list[list[int]] = []
    place: list = [None] * n
    y_total = 0
    for b in order:
        hb, wb = heights[b], widths[b]
        for s in shelves:
            if s[1] >= hb and s[2] + wb <= w_comp:
                place[b] = (s[0], s[2])
                s[2] += wb
                break
        else:
            shelves.append([y_total, hb, wb])
            place[b] = (y_total, 0)
            y_total += hb
    return place, shelves


def detection_layout(crop_shapes) -> tuple[tuple[int, int], list, np.ndarray]:
    """Layout of the detection composite: ((h, w), [(y0, x0, ch, cw)] per
    crop, bool interior mask).  Each crop is padded to 32-multiples so the
    retry tiles stay anchored at its own origin; each keeps its own 3-px
    zeroed ring frame."""
    pads = [(-(-h // TILE) * TILE, -(-w // TILE) * TILE) for h, w in crop_shapes]
    w_comp = max(pw for _, pw in pads)
    place, shelves = shelf_pack([ph for ph, _ in pads], [pw for _, pw in pads], w_comp)
    h_comp = shelves[-1][0] + shelves[-1][1]
    meta = [(y0, x0, h, w) for (y0, x0), (h, w) in zip(place, crop_shapes)]
    mask = np.zeros((h_comp, w_comp), bool)
    for y0, x0, h, w in meta:
        mask[y0 + 3 : y0 + h - 3, x0 + 3 : x0 + w - 3] = True
    check_mask_np(mask, (h_comp, w_comp))
    return (h_comp, w_comp), meta, mask


def detection_composite(crops: list) -> tuple[torch.Tensor, list, np.ndarray]:
    """(composite, [(y0, x0, ch, cw)] per crop, bool interior mask): the
    crops shelf-packed on one zeroed u8 image, laid out as the reference
    lays it out."""
    (h_comp, w_comp), meta, mask_np = detection_layout([tuple(c.shape) for c in crops])
    comp = torch.zeros((h_comp, w_comp), dtype=crops[0].dtype, device=crops[0].device)
    for crop, (y0, x0, h, w) in zip(crops, meta):
        comp[y0 : y0 + h, x0 : x0 + w] = crop
    return comp, meta, mask_np


def retry_nms(raw: torch.Tensor, ini_th: int, min_th: int) -> torch.Tensor:
    """The per-32x32-tile two-threshold retry (a tile keeps scores >= ini_th
    if it has any, else scores >= min_th), then strict 3x3 NMS; raw's sides
    are multiples of TILE."""
    hi = torch.where(raw >= ini_th, raw, 0)
    lo = torch.where(raw >= min_th, raw, 0)
    h, w = raw.shape
    tile_max = hi.view(h // TILE, TILE, w // TILE, TILE).amax(dim=(1, 3))
    use_hi = (tile_max > 0).repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)
    return nms3(torch.where(use_hi, hi, lo))


def detect_fused_plain(
    comp: torch.Tensor, mask: torch.Tensor, ini_th: int, min_th: int
) -> torch.Tensor:
    """Plain PyTorch twin of B3: the masked score, retry and NMS."""
    return retry_nms(raw_score_map_plain(comp, mask), ini_th, min_th)


def detect_fused(
    comp: torch.Tensor, mask: torch.Tensor, ini_th: int, min_th: int
) -> torch.Tensor:
    """(h, w) int32 NMS'd score map of a detection composite whose sides are
    multiples of TILE: masked FAST score, per-tile retry and strict 3x3 NMS
    in one call.

    CUDA tensor: launches the B3 kernel (two launches on the stream, one
    count).  CPU tensor: the plain twin.  The mask contract is that of
    `raw_score_map`."""
    if comp.dim() != 2 or comp.dtype != torch.uint8:
        raise TypeError(f"comp must be a 2-D uint8 tensor, got {comp.dtype} {tuple(comp.shape)}")
    h, w = comp.shape
    if h % TILE or w % TILE:
        raise ValueError(f"composite sides must be multiples of {TILE}, got {h}x{w}")
    if tuple(mask.shape) != (h, w) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool of shape {(h, w)}")
    if mask.device != comp.device:
        raise ValueError("mask must lie on the composite's device")
    if comp.device.type == "cpu":
        check_mask_np(mask.numpy(), comp.shape)
        return detect_fused_plain(comp, mask, ini_th, min_th)
    if comp.device.type != "cuda":
        raise ValueError(f"detect_fused: unsupported device {comp.device}")
    comp = comp.contiguous()
    mask = mask.contiguous()
    # the tile-selected map: scores lie in [-128, 254], so int16 is exact
    # for every ini_th and min_th
    sel = torch.empty((h, w), dtype=torch.int16, device=comp.device)
    out = torch.empty((h, w), dtype=torch.int32, device=comp.device)
    err = _build.kernels().detect_fused(
        comp.data_ptr(), mask.data_ptr(), sel.data_ptr(), out.data_ptr(), h, w,
        int(ini_th), int(min_th), stream_handle(comp),
    )
    detect_fused.launches += 1
    _build.check_launch("detect_fused", err)
    return out


detect_fused.launches = 0


def detect_two_threshold_multi(
    crops: list, ini_th: int, min_th: int, mask: torch.Tensor | None = None,
    fused: bool = False,
) -> list:
    """NMS'd score maps of SEVERAL detection crops in one composite pass.

    The crops are shelf-packed into one composite exactly as the reference
    lays it out (so the per-tile retry grid stays anchored per crop).  By
    default the score runs once (one B1 launch on CUDA), then the
    per-32x32-tile two-threshold retry and strict 3x3 NMS as tensor code;
    `fused` runs all three in B3 instead (the reference's
    ORBSLAM3_TPU_PALLAS_DETECT=1 path).  `mask` is the layout's interior
    mask, precomputed by a caller that runs the same geometry repeatedly."""
    if not crops:
        return []
    comp, meta, mask_np = detection_composite(crops)
    if mask is None:
        mask = torch.from_numpy(mask_np).to(comp.device)
    if fused:
        score = detect_fused(comp, mask, ini_th, min_th)
    else:
        score = retry_nms(raw_score_map(comp, mask), ini_th, min_th)
    return [score[y0 : y0 + h, x0 : x0 + w] for (y0, x0, h, w) in meta]
