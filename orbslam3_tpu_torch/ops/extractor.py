"""ORB extraction over prebuilt pyramids: selection, orientation, rBRIEF.

Counterpart of ``orbslam3_tpu/ops/extractor.py`` for its flat path (every
level active at its full quota — the standard geometry).  The cameras share
one batched selection, one orientation gather and one descriptor gather
over the camera-merged bordered composite, laid out exactly as the
reference lays it out.  Other geometries take the reference's per-level
`_extract_single`, which is not ported yet (ROADMAP A10).

Constant tables (moment weights, BRIEF pattern, blur taps, composite masks,
per-slot metadata) come from a `tables` object holding them on the device
(`frontend.stereo_frame.StereoFrontEnd`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu.oracle.orb_cpu import FAST_BORDER, PATCH_SIZE, PyramidParams
from orbslam3_tpu_torch.ops.brief import BRIEF_PAD, brief_descriptors
from orbslam3_tpu_torch.ops.fast import shelf_pack
from orbslam3_tpu_torch.ops.orientation import ic_angles
from orbslam3_tpu_torch.ops.pyramid import gaussian_blur7_u8, reflect101_pad
from orbslam3_tpu_torch.ops.select import select_topk_grid_multi

COMPOSITE_BAND = 4


class MergedComposites(NamedTuple):
    """Camera-merged bordered composites shared by orientation, BRIEF and
    the stereo SAD refinement (see the reference's class of this name).

    `bordered` holds every (camera, level) as a raw block inside a 4-px
    reflect-101 band; `sampling` is the same layout with the level
    interiors replaced by their 7x7 blur (zero-pad blur under the interior
    mask)."""

    bordered: torch.Tensor  # (h, w) u8
    sampling: torch.Tensor  # same shape
    y0: tuple               # y0[cam][level]: block top-left row
    x0: tuple               # x0[cam][level]: block top-left column
    pad: int


def merged_layout(block_shapes) -> tuple[tuple[int, int], list, np.ndarray]:
    """((h, w), place[b] = (y0, x0), interior mask) of the merged composite
    for blocks of `block_shapes` (camera-major, level-minor): shelf order
    (-width, -height, index) of the bordered blocks."""
    p = COMPOSITE_BAND
    hb = [h + 2 * p for h, _ in block_shapes]
    wb = [w + 2 * p for _, w in block_shapes]
    w_comp = max(wb)
    order = sorted(range(len(hb)), key=lambda b: (-wb[b], -hb[b], b))
    place, shelves = shelf_pack(hb, wb, w_comp, order=order)
    h_comp = shelves[-1][0] + shelves[-1][1]
    mask = np.zeros((h_comp, w_comp), bool)
    for (y0, x0), (h, w) in zip(place, block_shapes):
        mask[y0 + p : y0 + p + h, x0 + p : x0 + p + w] = True
    return (h_comp, w_comp), place, mask


def build_merged_composites(pyramids: list, tables) -> MergedComposites:
    p = COMPOSITE_BAND
    blocks = [img for pyr in pyramids for img in pyr]
    dev = blocks[0].device
    (h_comp, w_comp), place, _ = merged_layout([tuple(b.shape) for b in blocks])
    bordered = torch.zeros((h_comp, w_comp), dtype=torch.uint8, device=dev)
    for img, (y0, x0) in zip(blocks, place):
        h, w = img.shape
        bordered[y0 : y0 + h + 2 * p, x0 : x0 + w + 2 * p] = reflect101_pad(img, p)
    blurred = gaussian_blur7_u8(bordered, reflect=False, taps=tables.blur_taps)
    sampling = torch.where(tables.merged_mask, blurred, bordered)
    y0_all, x0_all, i = [], [], 0
    for pyr in pyramids:
        y0_all.append(tuple(place[b][0] for b in range(i, i + len(pyr))))
        x0_all.append(tuple(place[b][1] for b in range(i, i + len(pyr))))
        i += len(pyr)
    return MergedComposites(bordered, sampling, tuple(y0_all), tuple(x0_all), p)


class FrameFeatures(NamedTuple):
    """Fixed-size keypoint block; invalid slots are zeroed, not removed."""

    xy: torch.Tensor        # (K, 2) f32 — level-0 (full-res) coordinates
    response: torch.Tensor  # (K,) f32 — FAST corner score
    angle: torch.Tensor     # (K,) f32 — IC angle, degrees [0, 360)
    octave: torch.Tensor    # (K,) i32 — pyramid level
    size: torch.Tensor      # (K,) f32 — PATCH_SIZE * scale_factor[octave]
    valid: torch.Tensor     # (K,) bool
    desc: torch.Tensor      # (K, 32) u8 — rBRIEF

    @property
    def max_keypoints(self) -> int:
        return self.xy.shape[-2]


def active_levels(level_shapes, params: PyramidParams) -> list[int]:
    """Levels with a quota and a detection crop of at least 7x7."""
    quotas = [int(q) for q in params.features_per_level()]
    b = FAST_BORDER
    return [
        l for l, (h, w) in enumerate(level_shapes)
        if h - 2 * b >= 7 and w - 2 * b >= 7 and quotas[l] > 0
    ]


def detection_crops(pyramid: list, params: PyramidParams) -> tuple[list[int], list]:
    """(active levels, FAST detection crops) of a pyramid."""
    b = FAST_BORDER
    active = active_levels([tuple(img.shape) for img in pyramid], params)
    return active, [pyramid[l][b : -b, b : -b] for l in active]


def is_flat(level_shapes, params: PyramidParams, levels) -> bool:
    """True when every level is active at its full static quota — the
    geometry the merged-composite path handles."""
    b = FAST_BORDER
    quotas = [int(q) for q in params.features_per_level()]
    return list(levels) == list(range(len(level_shapes))) and all(
        min(quotas[l], (h - 2 * b) * (w - 2 * b)) == quotas[l]
        for l, (h, w) in enumerate(level_shapes)
    )


def slot_tables_np(params: PyramidParams, y0: tuple, x0: tuple, pad: int) -> dict:
    """Per-slot host constants of the flat path for len(y0) cameras:
    level-0 scale, octave and size per slot of one camera, and the (x, y)
    composite offsets of every slot of every camera for orientation (raw
    interior) and BRIEF (interior minus BRIEF_PAD)."""
    quotas = [int(q) for q in params.features_per_level()]
    scales = params.scale_factors
    scale_vec = np.repeat(
        np.asarray([1.0] + [float(s) for s in scales[1:]], np.float32), quotas
    )
    row = np.concatenate([np.repeat(np.asarray(y, np.int32), quotas) for y in y0])
    col = np.concatenate([np.repeat(np.asarray(x, np.int32), quotas) for x in x0])
    off = np.stack([col, row], axis=1)
    return dict(
        slot_scale=scale_vec,
        slot_octave=np.repeat(np.arange(len(quotas), dtype=np.int32), quotas),
        slot_size=(PATCH_SIZE * scale_vec).astype(np.float32),
        slot_off_orient=(off + pad).astype(np.int32),
        slot_off_brief=(off + pad - BRIEF_PAD).astype(np.int32),
    )


def extract_from_pyramids(
    pyramids: list,
    params: PyramidParams,
    scores_list: list,
    tables,
    comps: MergedComposites | None = None,
) -> list[FrameFeatures]:
    """Extraction for SEVERAL cameras' pyramids with shared device work
    (flat geometry only).  scores_list[c] maps level -> NMS'd score crop."""
    b = FAST_BORDER
    quotas = [int(q) for q in params.features_per_level()]
    for pyr, scores in zip(pyramids, scores_list):
        if not is_flat([tuple(i.shape) for i in pyr], params, sorted(scores)):
            raise NotImplementedError(
                "geometry with inactive or short levels needs the per-level "
                "extractor (_extract_single), not ported yet: ROADMAP A10"
            )
    n_cams = len(pyramids)
    n_lvl = len(pyramids[0])
    selections = select_topk_grid_multi(
        [scores_list[c][l] for c in range(n_cams) for l in range(n_lvl)], quotas * n_cams
    )
    k_cam = sum(quotas)

    xy_cats, resp_cats, valid_cats, safe_cats = [], [], [], []
    for c in range(n_cams):
        sel = selections[c * n_lvl : (c + 1) * n_lvl]
        xy_cat = torch.cat([s[0] for s in sel]) + b
        valid_cat = torch.cat([s[2] for s in sel])
        xy_cats.append(xy_cat)
        resp_cats.append(torch.cat([s[1] for s in sel]))
        valid_cats.append(valid_cat)
        # invalid slots read at a safe in-bounds xy and are zeroed below
        safe_cats.append(torch.where(valid_cat[:, None], xy_cat, b + 3))

    if comps is None:
        comps = build_merged_composites(pyramids, tables)

    xy_all = torch.cat(safe_cats)
    # orientation reads RAW pixels of the bordered composite
    angles_all = ic_angles(
        comps.bordered, xy_all + tables.slot_off_orient, weights=tables.ic_weights
    )
    # brief_descriptors adds BRIEF_PAD to both coords; the offsets subtract it
    desc_all = brief_descriptors(
        comps.sampling,
        (xy_all + tables.slot_off_brief).to(torch.float32),
        angles_all,
        pattern=tables.brief_pattern,
    )

    scale_vec = tables.slot_scale
    octave = tables.slot_octave
    size = tables.slot_size
    out = []
    for c in range(n_cams):
        v = valid_cats[c]
        angles = angles_all[c * k_cam : (c + 1) * k_cam]
        desc = desc_all[c * k_cam : (c + 1) * k_cam]
        out.append(
            FrameFeatures(
                xy=torch.where(
                    v[:, None], xy_cats[c].to(torch.float32) * scale_vec[:, None], 0.0
                ),
                response=torch.where(v, resp_cats[c].to(torch.float32), 0.0),
                angle=torch.where(v, angles, 0.0),
                octave=octave,
                size=size,
                valid=v,
                desc=torch.where(v[:, None], desc, 0),
            )
        )
    return out
