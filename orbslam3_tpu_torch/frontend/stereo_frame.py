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
refinement keeps its B2 launch.  On a geometry that is not flat each
camera takes the per-level `_extract_single` (one B2 launch each unless
fused), and the matcher still reads the camera-merged composite, as in
the reference.

`extract_and_match_stereo_packed_batch` runs B frames one after the
other into one (B, K, 40) block allocated up front: row b is the
single-frame program on pairs[b], no batch axis inside the program (the
reference's `lax.scan`, which its own A/B preferred to a `vmap`).

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
    MergedComposites,
    TableModule,
    build_merged_composites,
    detection_crops,
    extract_from_pyramids,
    extraction_tables_np,
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
        scales = params.scale_factors.astype(np.float32)
        tables = dict(
            extraction_tables_np(params, (h, w), 2),
            level_hw=np.asarray(sizes, np.int32),
            scale_factors=scales,
            inv_scale_factors=(np.float32(1.0) / scales).astype(np.float32),
        )
        return cls(params, image_hw, mbf, fx, tables, fused)

    def _check(self, pair: torch.Tensor) -> None:
        if tuple(pair.shape) != (2, *self.image_hw) or pair.dtype != torch.uint8:
            raise ValueError(
                f"expected a (2, {self.image_hw[0]}, {self.image_hw[1]}) uint8 "
                f"pair, got {pair.dtype} {tuple(pair.shape)}"
            )
        if pair.device != self.blur_taps.device:
            raise ValueError(f"pair on {pair.device}, front-end on {self.blur_taps.device}")

    def extract(self, pair: torch.Tensor) -> tuple[FrameFeatures, FrameFeatures]:
        """Both cameras' features of a (2, H, W) uint8 pair, without the
        left-right match (the fisheye path matches on the host)."""
        self._check(pair)
        feat_l, feat_r, _ = _extract_pair(pair, self.params, self, self.fused)
        return feat_l, feat_r

    def features(self, pair: torch.Tensor) -> StereoFrameFeatures:
        """Both cameras' features and the left-right match, unpacked."""
        self._check(pair)
        return _extract_and_match_stereo_impl(
            pair, self.params, self.mbf, self.fx, tables=self, fused=self.fused
        )

    def forward(self, pair: torch.Tensor) -> torch.Tensor:
        return _pack_features(self.features(pair))

    def batch(self, pairs: torch.Tensor) -> torch.Tensor:
        """(B, 2, H, W) uint8 -> (B, K, 40) f32: row b is `forward(pairs[b])`,
        written into one block allocated before the first frame runs."""
        if pairs.dim() != 4 or pairs.shape[0] == 0:
            raise ValueError(f"expected a (B, 2, H, W) batch, got {tuple(pairs.shape)}")
        k = sum(int(q) for q in self.params.features_per_level())  # the slots of a frame
        out = torch.empty((pairs.shape[0], k, PACK_COLS), dtype=torch.float32, device=pairs.device)
        for b in range(pairs.shape[0]):
            out[b] = self(pairs[b])
        return out


def _extract_pair(
    pair: torch.Tensor, params: PyramidParams, tables: StereoFrontEnd, fused: FusedKernels,
) -> tuple[FrameFeatures, FrameFeatures, MergedComposites]:
    """Both cameras' features and the camera-merged composites: both
    pyramids, one detection pass over both cameras' crops, then the
    extractor (shared work on the flat geometry, `_extract_single` per
    camera otherwise)."""
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
    return feat_l, feat_r, comps


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
        tables = _front_end_of(pair, params, mbf, fx, fused)
    feat_l, feat_r, comps = _extract_pair(pair, params, tables, fused)
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


def _front_end_of(
    pairs: torch.Tensor, params: PyramidParams, mbf: float, fx: float, fused: FusedKernels,
) -> StereoFrontEnd:
    """The cached front-end of a pair's (or a batch's) geometry and device."""
    if not isinstance(pairs, torch.Tensor):
        raise TypeError("pairs must be a torch.Tensor on the device to run on")
    return front_end(
        params, tuple(pairs.shape[-2:]), float(mbf), float(fx), str(pairs.device), fused
    )


def extract_and_match_stereo(
    pair: torch.Tensor,
    params: PyramidParams,
    mbf: float = DEFAULT_MBF,
    fx: float = DEFAULT_FX,
    fused: FusedKernels = FusedKernels(),
) -> StereoFrameFeatures:
    """(2, H, W) uint8 pair -> both cameras' features and the left-right
    match on the pair's device."""
    return _front_end_of(pair, params, mbf, fx, fused).features(pair)


def extract_and_match_stereo_sequence(
    pairs: torch.Tensor,
    params: PyramidParams,
    mbf: float = DEFAULT_MBF,
    fx: float = DEFAULT_FX,
    fused: FusedKernels = FusedKernels(),
) -> StereoFrameFeatures:
    """(N, 2, H, W) uint8 pairs -> `extract_and_match_stereo` of each, every
    leaf stacked along a leading N axis (the offline / mapping form)."""
    fe = _front_end_of(pairs, params, mbf, fx, fused)
    outs = [fe.features(pair) for pair in pairs]

    def stack(parts):
        return FrameFeatures(*(torch.stack(leaf) for leaf in zip(*parts)))

    return StereoFrameFeatures(
        stack([o.left for o in outs]), stack([o.right for o in outs]),
        torch.stack([o.u_right for o in outs]), torch.stack([o.depth for o in outs]),
    )


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
    return _front_end_of(pair, params, mbf, fx, fused)(pair)


def extract_and_match_stereo_packed_batch(
    pairs: torch.Tensor,
    params: PyramidParams,
    mbf: float = DEFAULT_MBF,
    fx: float = DEFAULT_FX,
    fused: FusedKernels = FusedKernels(),
) -> torch.Tensor:
    """(B, 2, H, W) uint8 -> (B, K, 40) f32 on the batch's device: row b is
    `extract_and_match_stereo_packed(pairs[b])` bit for bit (the batched
    prefetch's unit of work, `System.prefetch_stereo_batch`)."""
    return _front_end_of(pairs, params, mbf, fx, fused).batch(pairs)


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
