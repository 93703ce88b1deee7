"""Stereo frame front-end: L+R extraction + rectified LR matching.

Counterpart of ``orbslam3_tpu/frontend/stereo_frame.py``.  One call runs
the whole perception side of a stereo frame on the input's device: both
pyramids, one FAST composite pass for both cameras (one B1 launch), one
batched selection (K1's two launches, ``csrc/grid_pool.cu``), orientation
and rBRIEF over the camera-merged composite (one B2 launch gathers both
stages' windows), then the left-right match, `stereo_match`, in three
steps with no torch op between them on the card: the masked Hamming match
over the K x K pair grid with the SAD strips' starts (K2, one launch,
``csrc/stereo_hamming.cu``; `stereo_pairs`), the left and right strips
(one B2 launch) and the 11-slide SAD subpixel refinement with the
median-SAD filter (K3, two launches, ``csrc/sad_refine.cu``;
`sad_refine`).  A frame makes 1 B1, 2 B2, 2 K1, 1 K2 and 2 K3 launches.
On the CPU each kernel's wrapper runs its plain twin instead
(`ops/select.candidate_pools_plain`, `stereo_pairs_plain`,
`sad_refine_plain`: the torch ops the kernels replaced, bit for bit the
JAX package's).

Under `FusedKernels` detection runs B3 instead of B1 and orientation and
rBRIEF run B4 and B5's rBRIEF mode instead of their B2 windows; the SAD
refinement keeps its B2 launch.  On a geometry that is not flat each
camera takes the per-level `_extract_single` (one B2 launch and one
selection each unless fused), and the matcher still reads the
camera-merged composite, as in the reference.

As the reference runs the frame as one `jax.jit` dispatch, the port runs
it on CUDA as one CUDA graph replay (`utils.frame_graph.FrameGraph`):
`StereoFrontEnd.forward` replays the module's graph of the packed
program, captured at its first CUDA call, and `StereoFrontEnd.eager` runs
the same program op by op; `pair_block` (the fisheye path's two camera
blocks, no match) is the module's second graph.  `features` returns the
unpacked leaves and stays op by op.

`extract_and_match_stereo_packed_batch` runs B frames one after the
other into one (B, K, 40) block allocated up front: row b is a replay of
the single-frame graph on pairs[b], written into the block, no batch axis
inside the program (the reference's `lax.scan`, which its own A/B
preferred to a `vmap`); one graph serves every B.

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

from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch._device import stream_handle
from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams
from orbslam3_tpu_torch.ops.extractor import (
    PACK_COLS,
    ExtractorTables,
    FrameFeatures,
    FusedKernels,
    MergedComposites,
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


# rows of the (11, K) int32 block of the pair match (K2 and its twin):
# the match, then what the SAD strips and the refinement read
PAIR_ROWS = (
    "best_r", "best_dist", "tentative", "sul", "svl", "sur0", "in_bounds",
    "row_l", "col_l", "row_r", "col_r",
)
PAIR_ROW = {name: i for i, name in enumerate(PAIR_ROWS)}
# the median filter's factor as the reference writes it (a Python double;
# torch and XLA multiply the f32 median by its f32 rounding)
MEDIAN_FACTOR = 1.5 * 1.4


def stereo_pairs_plain(
    feat_l: FrameFeatures,
    feat_r: FrameFeatures,
    level_hw: torch.Tensor,           # (L, 2) int32 per-level (h, w)
    scale_factors: torch.Tensor,      # (L,) f32
    inv_scale_factors: torch.Tensor,  # (L,) f32, 1/scale in f32
    origins_l: tuple,                 # ((L,) row, (L,) col) level-block origins, int32
    origins_r: tuple,
    max_d: float,
) -> torch.Tensor:
    """Plain twin of K2: the (11, K) int32 block of `PAIR_ROWS` — the
    masked Hamming match over the K x K pair grid, then the SAD strips'
    rounded coordinates, bounds and clipped starts."""
    th_orb = (TH_HIGH + TH_LOW) // 2
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

    # --- the SAD strips at the left keypoint's level -----------------------
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
    wl, ww = 2 * SAD_W + 1, 2 * (SAD_L + SAD_W) + 1

    def clip(x, hi):  # per-level clips keep every window inside its block
        return torch.minimum(torch.clamp(x, min=0), hi)

    cl_svl = clip(svl - SAD_W, lh - wl)
    cl_sul = clip(sul - SAD_W, lw - wl)
    cl_sur = clip(sur0 - SAD_L - SAD_W, lw - ww)
    rows = (
        best_r, best_dist, tentative, sul, svl, sur0, in_bounds,
        origins_l[0][oct_l] + cl_svl, origins_l[1][oct_l] + cl_sul,
        origins_r[0][oct_l] + cl_svl, origins_r[1][oct_l] + cl_sur,
    )
    return torch.stack([r.to(torch.int32) for r in rows])


def _check_features(*feats: FrameFeatures) -> None:
    dev = feats[0].xy.device
    for f in feats:
        k = f.xy.shape[0]
        if (
            f.xy.dtype != torch.float32 or tuple(f.xy.shape) != (k, 2)
            or f.octave.dtype != torch.int32 or tuple(f.octave.shape) != (k,)
            or f.valid.dtype != torch.bool or tuple(f.valid.shape) != (k,)
            or f.desc.dtype != torch.uint8 or tuple(f.desc.shape) != (k, 32)
        ):
            raise TypeError("features must be FrameFeatures of (K, 2) f32 xy, int32 octaves, "
                            "bool validity and (K, 32) uint8 descriptors")
        if any(t.device != dev for t in (f.xy, f.octave, f.valid, f.desc)):
            raise ValueError("the features' leaves must lie on one device")


def stereo_pairs(
    feat_l: FrameFeatures, feat_r: FrameFeatures, level_hw: torch.Tensor,
    scale_factors: torch.Tensor, inv_scale_factors: torch.Tensor, origins_l: tuple,
    origins_r: tuple, max_d: float,
) -> torch.Tensor:
    """The (11, K) int32 block of `PAIR_ROWS`, equal to
    `stereo_pairs_plain`.  CUDA tensors: one launch of K2
    (``csrc/stereo_hamming.cu``); CPU tensors: the plain twin."""
    _check_features(feat_l, feat_r)
    dev = feat_l.xy.device
    tables = (level_hw, scale_factors, inv_scale_factors, *origins_l, *origins_r)
    if any(t.device != dev for t in (feat_r.xy, *tables)):
        raise ValueError("features and tables must lie on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu":
        return stereo_pairs_plain(feat_l, feat_r, level_hw, scale_factors, inv_scale_factors,
                                  origins_l, origins_r, max_d)
    if feat_r.xy.shape[0] > 0xFFFF:
        raise ValueError("K2 takes at most 65535 right slots")
    k_l = feat_l.xy.shape[0]
    out = torch.empty((len(PAIR_ROWS), k_l), dtype=torch.int32, device=dev)
    if k_l == 0:
        return out
    level_hw, scale_factors, inv_scale_factors = (
        t.contiguous() for t in (level_hw, scale_factors, inv_scale_factors)
    )
    if level_hw.dtype != torch.int32 or scale_factors.dtype != torch.float32:
        raise TypeError("level_hw must be int32 and the scale factors f32")
    sides = []
    for f, (row_off, col_off) in ((feat_l, origins_l), (feat_r, origins_r)):
        side = [f.xy.contiguous(), f.octave.contiguous(), f.valid.contiguous(),
                f.desc.contiguous(), row_off.to(torch.int32).contiguous(),
                col_off.to(torch.int32).contiguous()]
        sides.append(side)  # alive until the launch is queued
    ptrs = [[t.data_ptr() for t in side] for side in sides]
    err = _build.kernels().stereo_hamming(
        *ptrs[0], k_l, *ptrs[1], feat_r.xy.shape[0], scale_factors.data_ptr(),
        inv_scale_factors.data_ptr(), level_hw.data_ptr(), max_d, out.data_ptr(),
        stream_handle(out),
    )
    stereo_pairs.launches += 1
    _build.check_launch("stereo_hamming", err)
    return out


stereo_pairs.launches = 0


def sad_strips(
    comp_l: torch.Tensor, comp_r: torch.Tensor, pairs: torch.Tensor
) -> list[torch.Tensor]:
    """The (K, 11, 11) left windows of `comp_l` and (K, 11, 21) right
    strips of `comp_r` at the pair block's clipped starts: one B2 launch
    of two jobs on the card."""
    wl, ww = 2 * SAD_W + 1, 2 * (SAD_L + SAD_W) + 1
    return gather_windows_many([
        (comp_l, pairs[PAIR_ROW["row_l"]], pairs[PAIR_ROW["col_l"]], wl, wl),
        (comp_r, pairs[PAIR_ROW["row_r"]], pairs[PAIR_ROW["col_r"]], wl, ww),
    ])


def sad_refine_plain(
    p_l: torch.Tensor,   # (K, 11, 11) uint8 left windows
    p_r: torch.Tensor,   # (K, 11, 21) uint8 right strips
    pairs: torch.Tensor,  # (11, K) int32, `PAIR_ROWS`
    xy_l: torch.Tensor,   # (K, 2) f32 left keypoints
    oct_l: torch.Tensor,  # (K,) int32 left octave
    scale_factors: torch.Tensor,
    max_d: float,
    mbf: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K3: (u_right, depth) from the 11-slide SAD subpixel
    refinement and the median-SAD outlier filter."""
    wl = 2 * SAD_W + 1
    ul = xy_l[:, 0]
    tentative = pairs[PAIR_ROW["tentative"]] != 0
    in_bounds = pairs[PAIR_ROW["in_bounds"]] != 0
    sur0 = pairs[PAIR_ROW["sur0"]]
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

    best_ur = scale_factors[oct_l.to(torch.int64)] * (
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
    th = MEDIAN_FACTOR * median
    ok = ok & (n_ok > 0) & (sad < th)

    u_right = torch.where(ok, best_ur, -1.0)
    # a true f32 division: python `scalar / tensor` is reciprocal-times
    depth = torch.where(ok, torch.full_like(disparity, mbf) / disparity, -1.0)
    return u_right, depth


def sad_refine(
    p_l: torch.Tensor, p_r: torch.Tensor, pairs: torch.Tensor, xy_l: torch.Tensor,
    oct_l: torch.Tensor, scale_factors: torch.Tensor, max_d: float, mbf: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(u_right, depth), each (K,) f32, equal to `sad_refine_plain`.  CUDA
    tensors: the two launches of K3 (``csrc/sad_refine.cu``: per slot, then
    the one-block median), counted as two; CPU tensors: the plain twin."""
    k = p_l.shape[0]
    wl, ww = 2 * SAD_W + 1, 2 * (SAD_L + SAD_W) + 1
    if (
        tuple(p_l.shape) != (k, wl, wl) or tuple(p_r.shape) != (k, wl, ww)
        or p_l.dtype != torch.uint8 or p_r.dtype != torch.uint8
        or tuple(pairs.shape) != (len(PAIR_ROWS), k) or pairs.dtype != torch.int32
        or tuple(xy_l.shape) != (k, 2) or xy_l.dtype != torch.float32
        or tuple(oct_l.shape) != (k,) or oct_l.dtype != torch.int32
    ):
        raise TypeError(f"sad_refine: expected (K, {wl}, {wl}) and (K, {wl}, {ww}) uint8 strips, "
                        f"an ({len(PAIR_ROWS)}, K) int32 pair block, (K, 2) f32 keypoints and "
                        "(K,) int32 octaves")
    dev = p_l.device
    if any(t.device != dev for t in (p_r, pairs, xy_l, oct_l, scale_factors)):
        raise ValueError("sad_refine's inputs must lie on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu":
        return sad_refine_plain(p_l, p_r, pairs, xy_l, oct_l, scale_factors, max_d, mbf)
    u_right = torch.empty(k, dtype=torch.float32, device=dev)
    depth = torch.empty(k, dtype=torch.float32, device=dev)
    if k == 0:
        return u_right, depth
    scratch = torch.empty((4, k), dtype=torch.int32, device=dev)
    inputs = [p_l.contiguous(), p_r.contiguous(), pairs.contiguous(), xy_l.contiguous(),
              oct_l.contiguous(), scale_factors.to(torch.float32).contiguous()]
    err = _build.kernels().sad_refine(
        *(t.data_ptr() for t in inputs), k, max_d, mbf, MEDIAN_FACTOR, scratch.data_ptr(),
        u_right.data_ptr(), depth.data_ptr(), stream_handle(u_right),
    )
    sad_refine.launches += 2
    _build.check_launch("sad_refine", err)
    return u_right, depth


sad_refine.launches = 0


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
    """LR matcher; returns (u_right, depth) per left keypoint slot: the
    pair match (K2), the left and right SAD strips (one B2 launch), then
    the refinement and median filter (K3)."""
    max_d = mbf / mb
    comp_l, *origins_l = stack_l
    comp_r, *origins_r = stack_r
    pairs = stereo_pairs(feat_l, feat_r, level_hw, scale_factors, inv_scale_factors,
                         tuple(origins_l), tuple(origins_r), max_d)
    p_l, p_r = sad_strips(comp_l, comp_r, pairs)
    return sad_refine(p_l, p_r, pairs, feat_l.xy, feat_l.octave, scale_factors, max_d, mbf)


def _pack_features(out: StereoFrameFeatures) -> torch.Tensor:
    return pack_features(out.left, out.u_right, out.depth)


class StereoFrontEnd(ExtractorTables):
    """The stereo front-end of one image geometry, its constant tables held
    as buffers on the module's device.  `forward(pair)` takes a (2, H, W)
    uint8 tensor and returns the (K, 40) f32 packed block: on CUDA one
    replay of the module's graph of `eager`, the same program op by op."""

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

    def eager(self, pair: torch.Tensor) -> torch.Tensor:
        """The packed (K, 40) program op by op: what `forward` replays, and
        its spec."""
        return _pack_features(self.features(pair))

    def forward(self, pair: torch.Tensor) -> torch.Tensor:
        self._check(pair)
        return self.replay("packed", self.eager, pair)

    def pair_block_eager(self, pair: torch.Tensor) -> torch.Tensor:
        """(2, K, 40) f32: `pack_features` of the left and the right camera
        of `extract(pair)` (u_right / depth -1), op by op."""
        return torch.stack([pack_features(f) for f in self.extract(pair)])

    def pair_block(self, pair: torch.Tensor) -> torch.Tensor:
        """`pair_block_eager(pair)`, on CUDA as one replay of the module's
        second graph (the fisheye path's unit of work)."""
        self._check(pair)
        return self.replay("pair_block", self.pair_block_eager, pair)

    def batch(self, pairs: torch.Tensor) -> torch.Tensor:
        """(B, 2, H, W) uint8 -> (B, K, 40) f32: row b is `forward(pairs[b])`,
        the per-frame graph replayed into row b of one block allocated
        before the first frame runs."""
        if pairs.dim() != 4 or pairs.shape[0] == 0:
            raise ValueError(f"expected a (B, 2, H, W) batch, got {tuple(pairs.shape)}")
        k = sum(int(q) for q in self.params.features_per_level())  # the slots of a frame
        out = torch.empty((pairs.shape[0], k, PACK_COLS), dtype=torch.float32, device=pairs.device)
        for b in range(pairs.shape[0]):
            self._check(pairs[b])
            self.replay("packed", self.eager, pairs[b], out=out[b])
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
