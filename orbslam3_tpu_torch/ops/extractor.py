"""ORB extraction: detection, selection, orientation, rBRIEF.

Counterpart of ``orbslam3_tpu/ops/extractor.py``.  On the flat geometry
(every level active at its full quota — the standard one) the cameras
share one batched selection and one B2 launch that gathers the orientation
and descriptor windows over the camera-merged composites, laid out exactly
as the reference lays them out.  Other geometries take the reference's
per-level `_extract_single`.

Constant tables (resize and blur taps, moment weights, BRIEF pattern,
composite masks, per-slot metadata) come from a `tables` module holding
them on the device: `FeatureExtractor` for one camera,
`frontend.stereo_frame.StereoFrontEnd` for the stereo pair.  As the
reference dispatches `extract_features_jit` once a frame, the module runs
its frame program on CUDA as one CUDA graph replay
(`FeatureExtractor.packed`, `utils.frame_graph.FrameGraph`), captured at
its first call; `FeatureExtractor.eager` is the same program op by op.
`FusedKernels` picks the front-end's kernels, as the reference's three
environment switches do.  `split_lapping` orders a fisheye camera's
keypoints mono first, those in its lapping area at the tail.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch.oracle.orb_cpu import (
    FAST_BORDER,
    PATCH_SIZE,
    PyramidParams,
    gaussian_kernel7_fixed,
    ic_moment_weights,
)
from orbslam3_tpu_torch.ops.brief import (
    BRIEF_PAD,
    BRIEF_WINDOW,
    brief_descriptors,
    brief_pattern_np,
    brief_sampling_image,
    brief_window_starts,
)
from orbslam3_tpu_torch.ops.fast import detect_two_threshold_multi, detection_layout, shelf_pack
from orbslam3_tpu_torch.ops.orientation import IC_WINDOW, ic_angles, ic_window_starts
from orbslam3_tpu_torch.ops.pyramid import (
    ResizeTaps,
    build_pyramid,
    gaussian_blur7_u8,
    reflect101_pad,
    resize_taps_np,
)
from orbslam3_tpu_torch.ops.select import select_topk_grid_multi
from orbslam3_tpu_torch.ops.window_gather import gather_windows_many
from orbslam3_tpu_torch.utils.frame_graph import TableModule


class FusedKernels(NamedTuple):
    """The front-end's fused-kernel configuration: the port's explicit
    counterpart of the reference's ORBSLAM3_TPU_PALLAS_DETECT / _MOMENTS /
    _SAMPLE switches, off by default as there.  Off, detection runs B1 plus
    tensor code and orientation / rBRIEF run over B2 windows, both gathered
    in one B2 launch; on, each runs its fused kernel instead."""

    detect: bool = False   # B3: score, per-tile retry and NMS in one call
    moments: bool = False  # B4: the IC moments without a (K, 31, 31) window block
    sample: bool = False   # B5's rBRIEF mode: the descriptors in one launch, no window block


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


def _angles_and_descriptors(
    raw: torch.Tensor, xy_orient: torch.Tensor, sampling: torch.Tensor, xy_brief: torch.Tensor,
    tables, fused: FusedKernels,
) -> tuple[torch.Tensor, torch.Tensor]:
    """IC angles of the integer centres `xy_orient` in the raw image and
    rBRIEF descriptors of the f32 `xy_brief` in the sampling image.  The
    stages that run over B2 windows (those not under `fused`) get them from
    one `gather_windows_many` launch: the window starts do not depend on
    the angles."""
    jobs = {}
    if not fused.moments:
        jobs["orient"] = (raw, *ic_window_starts(xy_orient), IC_WINDOW, IC_WINDOW)
    if not fused.sample:
        jobs["brief"] = (sampling, *brief_window_starts(xy_brief), BRIEF_WINDOW, BRIEF_WINDOW)
    windows = dict(zip(jobs, gather_windows_many(jobs.values())))
    angles = ic_angles(
        windows.get("orient", raw), xy_orient, weights=tables.ic_weights, fused=fused.moments
    )
    desc = brief_descriptors(
        windows.get("brief", sampling), xy_brief, angles, pattern=tables.brief_pattern,
        fused=fused.sample,
    )
    return angles, desc


def extract_from_pyramids(
    pyramids: list,
    params: PyramidParams,
    scores_list: list,
    tables,
    comps: MergedComposites | None = None,
    fused: FusedKernels = FusedKernels(),
) -> list[FrameFeatures]:
    """Extraction for SEVERAL cameras' pyramids with shared device work on
    the flat geometry; any other geometry takes `_extract_single` per
    camera, as in the reference.  scores_list[c] maps level -> NMS'd score
    crop."""
    b = FAST_BORDER
    quotas = [int(q) for q in params.features_per_level()]
    if not all(
        is_flat([tuple(i.shape) for i in pyr], params, sorted(scores))
        for pyr, scores in zip(pyramids, scores_list)
    ):
        return [
            _extract_single(pyr, params, scores, tables, fused)
            for pyr, scores in zip(pyramids, scores_list)
        ]
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
    # orientation reads RAW pixels of the bordered composite; BRIEF adds
    # BRIEF_PAD to both coords, the offsets subtract it
    angles_all, desc_all = _angles_and_descriptors(
        comps.bordered, xy_all + tables.slot_off_orient,
        comps.sampling, (xy_all + tables.slot_off_brief).to(torch.float32), tables, fused,
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


def _empty_level_block(k: int, device) -> FrameFeatures:
    f32 = dict(dtype=torch.float32, device=device)
    return FrameFeatures(
        xy=torch.zeros((k, 2), **f32),
        response=torch.zeros((k,), **f32),
        angle=torch.zeros((k,), **f32),
        octave=torch.zeros((k,), dtype=torch.int32, device=device),
        size=torch.zeros((k,), **f32),
        valid=torch.zeros((k,), dtype=torch.bool, device=device),
        desc=torch.zeros((k, 32), dtype=torch.uint8, device=device),
    )


def _extract_single(
    pyramid: list, params: PyramidParams, scores: dict, tables,
    fused: FusedKernels = FusedKernels(),
) -> FrameFeatures:
    """The reference's per-level path, for geometries that are not flat
    (inactive levels, or levels smaller than their quota): one batched
    selection with per-level quotas min(quota, crop area), then the
    orientation windows of the vertically stacked raw levels and the
    descriptor windows of the stacked per-level sampling images (each
    level blurred on its own with reflect-101, inside a 19-px reflect-101
    border).  Each level's block is padded to its static quota, invalid
    slots zeroed."""
    quotas = [int(q) for q in params.features_per_level()]
    scales = params.scale_factors
    b = FAST_BORDER
    dev = pyramid[0].device
    sel_levels = [l for l in range(len(pyramid)) if l in scores]
    k_effs = [
        min(quotas[l], (pyramid[l].shape[0] - 2 * b) * (pyramid[l].shape[1] - 2 * b))
        for l in sel_levels
    ]
    selections = select_topk_grid_multi([scores[l] for l in sel_levels], k_effs)
    per_level = {}
    if sel_levels:
        safe_xys, raw_rows, samp_rows, y0_raw, y0_samp = [], [], [], [], []
        raw_wmax = max(pyramid[l].shape[1] for l in sel_levels)
        samp_wmax = raw_wmax + 2 * BRIEF_PAD
        for level, (xy_c, _, valid) in zip(sel_levels, selections):
            # detection border back; invalid slots read at a safe in-bounds xy
            safe_xys.append(torch.where(valid[:, None], xy_c + b, b + 3))
            img = pyramid[level]
            samp = brief_sampling_image(img, gaussian_blur7_u8(img, taps=tables.blur_taps))
            y0_raw.append(sum(r.shape[0] for r in raw_rows))
            y0_samp.append(sum(r.shape[0] for r in samp_rows))
            raw_rows.append(torch.nn.functional.pad(img, (0, raw_wmax - img.shape[1])))
            samp_rows.append(torch.nn.functional.pad(samp, (0, samp_wmax - samp.shape[1])))

        def offsets(y0s):  # per-slot (0, row) origins of each level's block,
            # made on the device: no host-to-device copy inside the frame program
            row = torch.cat([
                torch.full((k,), y0, dtype=torch.int32, device=dev) for y0, k in zip(y0s, k_effs)
            ])
            return torch.stack([torch.zeros_like(row), row], dim=1)

        xy_all = torch.cat(safe_xys)
        angles_all, desc_all = _angles_and_descriptors(
            torch.cat(raw_rows), xy_all + offsets(y0_raw),
            torch.cat(samp_rows), (xy_all + offsets(y0_samp)).to(torch.float32), tables, fused,
        )
        starts = np.cumsum([0] + k_effs)
        for i, (level, (xy_c, resp, valid)) in enumerate(zip(sel_levels, selections)):
            sl = slice(int(starts[i]), int(starts[i + 1]))
            per_level[level] = (xy_c + b, resp, valid, angles_all[sl], desc_all[sl])

    blocks = []
    for level in range(len(pyramid)):
        k = quotas[level]
        if level not in per_level:
            blocks.append(_empty_level_block(max(k, 0), dev))
            continue
        xy_i, resp, valid, angles, desc = per_level[level]
        k_eff = valid.shape[0]
        scale = float(scales[level])
        # the reference multiplies in f32 by the f32-rounded scale
        mult = float(np.float32(scale)) if level != 0 else 1.0
        blk = FrameFeatures(
            xy=xy_i.to(torch.float32) * mult,
            response=resp.to(torch.float32),
            angle=angles,
            octave=torch.full((k_eff,), level, dtype=torch.int32, device=dev),
            size=torch.full((k_eff,), PATCH_SIZE * scale, dtype=torch.float32, device=dev),
            valid=valid,
            desc=desc,
        )
        if k_eff < k:  # pad the block to the static quota
            pad = _empty_level_block(k - k_eff, dev)
            blk = FrameFeatures(*(torch.cat([a, p]) for a, p in zip(blk, pad)))
        v = blk.valid
        blocks.append(blk._replace(
            xy=torch.where(v[:, None], blk.xy, 0.0),
            response=torch.where(v, blk.response, 0.0),
            angle=torch.where(v, blk.angle, 0.0),
            desc=torch.where(v[:, None], blk.desc, 0),
        ))
    return FrameFeatures(*(torch.cat(parts) for parts in zip(*blocks)))


def extract_from_pyramid(
    pyramid: list, params: PyramidParams, tables, scores: dict | None = None,
    fused: FusedKernels = FusedKernels(),
) -> FrameFeatures:
    """Extraction of one camera's prebuilt pyramid; `scores` (level ->
    NMS'd score crop) skips detection.  Detection runs one composite pass
    over every active level (B1, or B3 under `fused.detect`)."""
    if scores is None:
        active, crops = detection_crops(pyramid, params)
        score_list = detect_two_threshold_multi(
            crops, params.ini_th_fast, params.min_th_fast, mask=tables.det_mask,
            fused=fused.detect,
        )
        scores = dict(zip(active, score_list))
    return extract_from_pyramids([pyramid], params, [scores], tables, fused=fused)[0]


def extract_features(
    image: torch.Tensor, params: PyramidParams, tables, fused: FusedKernels = FusedKernels()
) -> FrameFeatures:
    """Full ORB extraction of one (H, W) uint8 image on its device, with
    the constant tables of its geometry (`FeatureExtractor`)."""
    return extract_from_pyramid(
        build_pyramid(image, params, tables.resize_taps()), params, tables, fused=fused
    )


# columns of the packed host-transfer layout
PACK_COLS = 40  # x, y, response, angle, octave, valid, u_right, depth, desc[32]


def pack_features(
    f: FrameFeatures, u_right: torch.Tensor | None = None, depth: torch.Tensor | None = None
) -> torch.Tensor:
    """(K, 40) f32 host-transfer block: x, y, response, angle, octave,
    valid, u_right, depth, desc[32]; u_right and depth are -1 when not
    given (one camera).  One device->host copy carries the whole frame."""
    if u_right is None:
        u_right = torch.full_like(f.response, -1.0)
    if depth is None:
        depth = torch.full_like(f.response, -1.0)
    cols = [
        f.xy[:, 0], f.xy[:, 1], f.response, f.angle,
        f.octave.to(torch.float32), f.valid.to(torch.float32), u_right, depth,
    ]
    return torch.cat([torch.stack(cols, dim=1), f.desc.to(torch.float32)], dim=1)


class ExtractorTables(TableModule):
    """A `TableModule` that holds an extractor's resize taps."""

    def resize_taps(self) -> ResizeTaps:
        return ResizeTaps(*(getattr(self, f"resize_{f}") for f in ResizeTaps._fields))


def extraction_tables_np(params: PyramidParams, image_hw: tuple, n_cams: int) -> dict:
    """The extractor's constant tables for `n_cams` cameras of one geometry,
    from the numpy oracle's sources (the port's copy): the resize taps
    (`_linear_coeffs`), blur taps (`gaussian_kernel7_fixed`), IC moment
    weights (`ic_moment_weights`), BRIEF pattern (`BIT_PATTERN_31`), the
    detection mask of every camera's active crops, the merged composite's
    interior mask and the interior origins of each (camera, level) block
    (`row_off`, `col_off`; the stereo matcher reads them on every
    geometry, as the reference builds the merged composites on every
    geometry).  The flat geometry adds the per-slot tables."""
    h, w = image_hw
    sizes = params.level_sizes(h, w)
    active = active_levels(sizes, params)
    b = FAST_BORDER
    _, _, det_mask = detection_layout(
        [(sizes[l][0] - 2 * b, sizes[l][1] - 2 * b) for l in active] * n_cams
    )
    tables = dict(
        {f"resize_{k}": v for k, v in resize_taps_np(h, w, sizes[1:]).items()},
        blur_taps=gaussian_kernel7_fixed().astype(np.int32),
        ic_weights=np.stack(ic_moment_weights()).astype(np.int32),
        brief_pattern=brief_pattern_np(),
        det_mask=det_mask,
    )
    _, place, merged_mask = merged_layout(sizes * n_cams)
    n = len(sizes)
    y0 = tuple(tuple(p[0] for p in place[c * n : (c + 1) * n]) for c in range(n_cams))
    x0 = tuple(tuple(p[1] for p in place[c * n : (c + 1) * n]) for c in range(n_cams))
    tables.update(
        merged_mask=merged_mask,
        row_off=np.asarray(y0, np.int32) + COMPOSITE_BAND,
        col_off=np.asarray(x0, np.int32) + COMPOSITE_BAND,
    )
    if is_flat(sizes, params, active):
        tables.update(slot_tables_np(params, y0, x0, COMPOSITE_BAND))
    return tables


def split_lapping(feat_np: dict, lapping: tuple[float, float]) -> tuple[np.ndarray, int]:
    """Order valid slots mono-first / stereo-tail (operator() :1289-1303).

    Returns (permutation over valid entries, mono_index).
    """
    xy = feat_np["xy"]
    valid = feat_np["valid"]
    idx = np.nonzero(valid)[0]
    in_lap = (xy[idx, 0] >= lapping[0]) & (xy[idx, 0] <= lapping[1])
    order = np.concatenate([idx[~in_lap], idx[in_lap][::-1]])
    return order, int((~in_lap).sum())


class FeatureExtractor(ExtractorTables):
    """The ORB extractor of one camera geometry (the reference's
    `extract_features_jit` for one image shape), its constant tables held
    as buffers on the module's device.  `forward(image)` takes an (H, W)
    uint8 tensor and returns its `FrameFeatures`, op by op; `packed(image)`
    returns the (K, 40) packed block, on CUDA as one graph replay."""

    def __init__(
        self, params: PyramidParams, image_hw: tuple, tables: dict[str, np.ndarray],
        fused: FusedKernels = FusedKernels(),
    ):
        super().__init__(tables)
        self.params = params
        self.image_hw = tuple(image_hw)
        self.fused = FusedKernels(*fused)

    @classmethod
    def from_reference(
        cls, params: PyramidParams, image_hw: tuple, fused: FusedKernels = FusedKernels()
    ) -> "FeatureExtractor":
        """Tables from the numpy oracle's sources (`extraction_tables_np`)."""
        return cls(params, image_hw, extraction_tables_np(params, tuple(image_hw), 1), fused)

    def _check(self, image: torch.Tensor) -> None:
        if tuple(image.shape) != self.image_hw or image.dtype != torch.uint8:
            raise ValueError(
                f"expected a {self.image_hw} uint8 image, got {image.dtype} {tuple(image.shape)}"
            )
        if image.device != self.blur_taps.device:
            raise ValueError(f"image on {image.device}, extractor on {self.blur_taps.device}")

    def forward(self, image: torch.Tensor) -> FrameFeatures:
        self._check(image)
        return extract_features(image, self.params, self, self.fused)

    def eager(self, image: torch.Tensor) -> torch.Tensor:
        """The (K, 40) packed block of `forward(image)`, op by op: the
        program `packed` replays, and its spec."""
        return pack_features(self(image))

    def packed(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W) uint8 -> the (K, 40) f32 packed block, equal to
        `eager(image)` bit for bit: on CUDA one replay of this extractor's
        graph (the reference's one `extract_features_jit` dispatch)."""
        self._check(image)
        return self.replay("packed", self.eager, image)


@functools.lru_cache(maxsize=8)
def feature_extractor(
    params: PyramidParams, image_hw: tuple, fused: FusedKernels, device: str
) -> FeatureExtractor:
    """The extractor of one geometry and configuration on one device, built
    once per process (mono keeps two: the 5x-feature init extractor and
    the normal one)."""
    return FeatureExtractor.from_reference(params, image_hw, fused).to(device)
