"""Stereo frame front-end: L+R extraction + rectified LR matching.

Counterpart of ``orbslam3_tpu/frontend/stereo_frame.py``.  One call runs
the whole perception side of a stereo frame on the input's device: both
pyramids, one FAST composite pass for both cameras (one B1 launch), one
batched selection, orientation and rBRIEF over the camera-merged composite
(one B2 launch gathers both stages' windows), then the masked Hamming
match with the 11-slide SAD subpixel refinement (one B2 launch gathers the
left and right strips) and the median-SAD filter: two B2 launches a frame.

Under `FusedKernels` detection runs B3 instead of B1 and orientation and
rBRIEF run B4 and B5's rBRIEF mode instead of their B2 windows; the SAD
refinement keeps its B2 launch.

`StereoFrontEnd` holds the constant tables of one image geometry as module
buffers; `StereoFrontEnd.from_reference` builds them from the numpy
oracle tables (``oracle/orb_cpu.py``, the port's copy of the JAX
package's), so both packages compute from identical numbers.  The reference's masked-lane-reduce lookups are plain indexing
here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams
from orbslam3_tpu_torch.ops.extractor import (
    PACK_COLS,
    FrameFeatures,
    FusedKernels,
    TableModule,
    active_levels,
    build_merged_composites,
    detection_crops,
    extract_from_pyramids,
    extraction_tables_np,
    is_flat,
    pack_features,
)
from orbslam3_tpu_torch.ops.fast import detect_two_threshold_multi
from orbslam3_tpu_torch.ops.matching import BIG, TH_HIGH, TH_LOW, hamming_matrix
from orbslam3_tpu_torch.ops.pyramid import build_pyramid
from orbslam3_tpu_torch.ops.window_gather import gather_windows_many

SAD_W = 5
SAD_L = 5

# EuRoC-like defaults (cam0 pinhole, ~0.11 m baseline)
DEFAULT_FX = 435.2046959714599
DEFAULT_MBF = 47.90639384423901


class StereoFrameFeatures(NamedTuple):
    left: FrameFeatures
    right: FrameFeatures
    u_right: torch.Tensor  # (K,) f32 — refined right x per left slot, -1 if none
    depth: torch.Tensor    # (K,) f32 — mbf/disparity, -1 if none


def stereo_match(
    feat_l: FrameFeatures,
    feat_r: FrameFeatures,
    stack_l: tuple,   # (composite, (L,) row origins, (L,) col origins) — int32 tensors
    stack_r: tuple,
    level_hw: torch.Tensor,       # (L, 2) int32 per-level (h, w)
    scale_factors: torch.Tensor,  # (L,) f32
    inv_scale_factors: torch.Tensor,  # (L,) f32, 1/scale in f32
    mbf: float,
    mb: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """LR matcher; returns (u_right, depth) per left keypoint slot."""
    th_orb = (TH_HIGH + TH_LOW) // 2
    max_d = mbf / mb
    ul, vl = feat_l.xy[:, 0], feat_l.xy[:, 1]
    ur, vr = feat_r.xy[:, 0], feat_r.xy[:, 1]
    oct_l = feat_l.octave.to(torch.int64)
    oct_r = feat_r.octave.to(torch.int64)

    # --- candidate masks over the K x K pair grid -------------------------
    row = vl.to(torch.int32).to(torch.float32)  # trunc(vL), as reference
    r_r = 2.0 * scale_factors[oct_r]
    row_ok = (row[:, None] >= torch.floor(vr - r_r)[None, :]) & (
        row[:, None] <= torch.ceil(vr + r_r)[None, :]
    )
    oct_ok = (oct_r[None, :] >= oct_l[:, None] - 1) & (oct_r[None, :] <= oct_l[:, None] + 1)
    u_ok = (ur[None, :] >= (ul - max_d)[:, None]) & (ur[None, :] <= ul[:, None])
    pair_ok = row_ok & oct_ok & u_ok & feat_l.valid[:, None] & feat_r.valid[None, :]

    d = torch.where(pair_ok, hamming_matrix(feat_l.desc, feat_r.desc), BIG)
    best_dist = d.min(dim=1).values
    best_r = torch.argmin(d, dim=1)  # first minimum on ties (C-h5)
    tentative = best_dist < th_orb

    # --- SAD subpixel refinement at the left keypoint's level -------------
    inv = inv_scale_factors[oct_l]
    sul = torch.round(ul * inv).to(torch.int32)
    svl = torch.round(vl * inv).to(torch.int32)
    sur0 = torch.round(ur[best_r] * inv).to(torch.int32)
    lh = level_hw[oct_l, 0]
    lw = level_hw[oct_l, 1]
    in_bounds = (
        (svl - SAD_W >= 0) & (svl + SAD_W + 1 <= lh)
        & (sul - SAD_W >= 0) & (sul + SAD_W + 1 <= lw)
        & (sur0 - SAD_L - SAD_W >= 0) & (sur0 + SAD_L + SAD_W + 1 <= lw)
    )
    comp_l, row_off_l, col0_l = stack_l
    comp_r, row_off_r, col0_r = stack_r
    wl, ww = 2 * SAD_W + 1, 2 * (SAD_L + SAD_W) + 1

    def clip(x, hi):  # per-level clips keep every window inside its block
        return torch.minimum(torch.clamp(x, min=0), hi)

    cl_svl = clip(svl - SAD_W, lh - wl)
    cl_sul = clip(sul - SAD_W, lw - wl)
    cl_sur = clip(sur0 - SAD_L - SAD_W, lw - ww)
    p_l, p_r = gather_windows_many([
        (comp_l, row_off_l[oct_l] + cl_svl, col0_l[oct_l] + cl_sul, wl, wl),
        (comp_r, row_off_r[oct_l] + cl_svl, col0_r[oct_l] + cl_sur, wl, ww),
    ])
    p_l = p_l.to(torch.int32)
    p_r = p_r.to(torch.int32)
    # SAD of slide j: left window against right columns [j, j + 11); int32
    # sums are exact, then f32 for the parabola as in the reference
    dists = torch.stack(
        [(p_l - p_r[:, :, j : j + wl]).abs().sum(dim=(1, 2)) for j in range(2 * SAD_L + 1)],
        dim=1,
    ).to(torch.float32)  # (K, 11)
    sad = dists.min(dim=1).values
    best_j = torch.argmin(dists, dim=1)  # first minimum on ties (C-h5)
    inc_ok = (best_j > 0) & (best_j < 2 * SAD_L)
    jm = best_j.clamp(1, 2 * SAD_L - 1)
    d1 = dists.gather(1, (jm - 1)[:, None])[:, 0]
    d2 = dists.gather(1, jm[:, None])[:, 0]
    d3 = dists.gather(1, (jm + 1)[:, None])[:, 0]
    denom = 2.0 * (d1 + d3 - 2.0 * d2)
    delta = torch.where(denom != 0, (d1 - d3) / denom, 0.0)
    delta_ok = (delta >= -1.0) & (delta <= 1.0)

    best_ur = scale_factors[oct_l] * (
        sur0.to(torch.float32) + (best_j - SAD_L).to(torch.float32) + delta
    )
    disparity = ul - best_ur
    disp_ok = (disparity >= 0.0) & (disparity < max_d)
    clamped = disparity <= 0.0
    disparity = torch.where(clamped, 0.01, disparity)
    best_ur = torch.where(clamped, ul - 0.01, best_ur)

    ok = tentative & in_bounds & inc_ok & delta_ok & disp_ok

    # --- median-of-SAD outlier filter ------------------------------------
    n_ok = ok.sum()
    sorted_sad, _ = torch.sort(torch.where(ok, sad, float(BIG)))
    mid = torch.clamp(n_ok // 2, max=sad.shape[0] - 1).view(1)
    median = sorted_sad.index_select(0, mid)[0]
    th = 1.5 * 1.4 * median
    ok = ok & (n_ok > 0) & (sad < th)

    u_right = torch.where(ok, best_ur, -1.0)
    # a true f32 division: python `scalar / tensor` is reciprocal-times
    depth = torch.where(ok, torch.full_like(disparity, mbf) / disparity, -1.0)
    return u_right, depth


def _pack_features(out: StereoFrameFeatures) -> torch.Tensor:
    return pack_features(out.left, out.u_right, out.depth)


class StereoFrontEnd(TableModule):
    """The stereo front-end of one image geometry, its constant tables held
    as buffers on the module's device.  `forward(pair)` takes a (2, H, W)
    uint8 tensor and returns the (K, 40) f32 packed block."""

    def __init__(
        self, params: PyramidParams, image_hw: tuple, mbf: float, fx: float,
        tables: dict[str, np.ndarray], fused: FusedKernels = FusedKernels(),
    ):
        super().__init__(tables)
        self.params = params
        self.image_hw = tuple(image_hw)
        self.mbf = float(mbf)
        self.fx = float(fx)
        self.fused = FusedKernels(*fused)

    @classmethod
    def from_reference(
        cls, params: PyramidParams, image_hw: tuple, mbf: float = DEFAULT_MBF,
        fx: float = DEFAULT_FX, fused: FusedKernels = FusedKernels(),
    ) -> "StereoFrontEnd":
        """Constant tables from the numpy oracle's sources: the
        extractor's tables of both cameras (`extraction_tables_np`) plus the
        level sizes and scale factors of `PyramidParams` for the matcher."""
        h, w = image_hw
        sizes = params.level_sizes(h, w)
        if not is_flat(sizes, params, active_levels(sizes, params)):
            raise NotImplementedError(
                f"{h}x{w} with {params} is not the flat geometry; the stereo "
                "front-end for other geometries is not ported yet: ROADMAP A10"
            )
        scales = params.scale_factors.astype(np.float32)
        tables = dict(
            extraction_tables_np(params, (h, w), 2),
            level_hw=np.asarray(sizes, np.int32),
            scale_factors=scales,
            inv_scale_factors=(np.float32(1.0) / scales).astype(np.float32),
        )
        return cls(params, image_hw, mbf, fx, tables, fused)

    def forward(self, pair: torch.Tensor) -> torch.Tensor:
        if tuple(pair.shape) != (2, *self.image_hw) or pair.dtype != torch.uint8:
            raise ValueError(
                f"expected a (2, {self.image_hw[0]}, {self.image_hw[1]}) uint8 "
                f"pair, got {pair.dtype} {tuple(pair.shape)}"
            )
        if pair.device != self.blur_taps.device:
            raise ValueError(f"pair on {pair.device}, front-end on {self.blur_taps.device}")
        return _pack_features(
            _extract_and_match_stereo_impl(
                pair, self.params, self.mbf, self.fx, tables=self, fused=self.fused
            )
        )


def _extract_and_match_stereo_impl(
    pair: torch.Tensor,
    params: PyramidParams,
    mbf: float = DEFAULT_MBF,
    fx: float = DEFAULT_FX,
    tables: StereoFrontEnd | None = None,
    fused: FusedKernels = FusedKernels(),
) -> StereoFrameFeatures:
    """pair: (2, H, W) uint8 — the full stereo perception front-end;
    `tables` defaults to the cached front-end of this geometry."""
    if tables is None:
        tables = front_end(
            params, tuple(pair.shape[1:]), float(mbf), float(fx), str(pair.device), fused
        )
    pyr_l = build_pyramid(pair[0], params, tables.resize_taps())
    pyr_r = build_pyramid(pair[1], params, tables.resize_taps())
    act_l, crops_l = detection_crops(pyr_l, params)
    act_r, crops_r = detection_crops(pyr_r, params)
    score_list = detect_two_threshold_multi(
        crops_l + crops_r, params.ini_th_fast, params.min_th_fast, mask=tables.det_mask,
        fused=fused.detect,
    )
    comps = build_merged_composites([pyr_l, pyr_r], tables)
    feat_l, feat_r = extract_from_pyramids(
        [pyr_l, pyr_r],
        params,
        [
            dict(zip(act_l, score_list[: len(act_l)])),
            dict(zip(act_r, score_list[len(act_l) :])),
        ],
        tables,
        comps=comps,
        fused=fused,
    )
    # the SAD refinement reads the bordered raw composite; the interior
    # offset +pad is folded into the per-level origins
    u_right, depth = stereo_match(
        feat_l,
        feat_r,
        (comps.bordered, tables.row_off[0], tables.col_off[0]),
        (comps.bordered, tables.row_off[1], tables.col_off[1]),
        tables.level_hw,
        tables.scale_factors,
        tables.inv_scale_factors,
        mbf,
        mbf / fx,
    )
    return StereoFrameFeatures(feat_l, feat_r, u_right, depth)


@functools.lru_cache(maxsize=8)
def front_end(
    params: PyramidParams, image_hw: tuple, mbf: float, fx: float, device: str,
    fused: FusedKernels = FusedKernels(),
) -> StereoFrontEnd:
    """The front-end of one geometry and configuration on one device, built
    once per process."""
    return StereoFrontEnd.from_reference(params, image_hw, mbf, fx, fused).to(device)


def extract_and_match_stereo_packed(
    pair: torch.Tensor,
    params: PyramidParams,
    mbf: float = DEFAULT_MBF,
    fx: float = DEFAULT_FX,
    fused: FusedKernels = FusedKernels(),
) -> torch.Tensor:
    """(2, H, W) uint8 pair -> ONE (K, 40) f32 block on the pair's device:
    the left camera block + u_right/depth (unpack with
    `unpack_host_features`)."""
    if not isinstance(pair, torch.Tensor):
        raise TypeError("pair must be a torch.Tensor on the device to run on")
    return _pack_features(_extract_and_match_stereo_impl(pair, params, mbf, fx, fused=fused))


def unpack_host_features(arr: np.ndarray) -> dict:
    """Host-side inverse of extract_and_match_stereo_packed (compacted)."""
    valid = arr[:, 5] > 0.5
    a = arr[valid]
    return dict(
        kps=a[:, 0:2],
        response=a[:, 2],
        angle=a[:, 3],
        octave=a[:, 4].astype(np.int32),
        u_right=a[:, 6],
        depth=a[:, 7],
        desc=a[:, 8:40].astype(np.uint8),
    )
