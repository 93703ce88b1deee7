"""Check and time the selection and stereo-match kernels K1, K2 and K3 on the card.

    python -m orbslam3_tpu_torch.tools.bench_match_kernels [--reps N]

Builds the kernels of the tree it is run from and holds K1
(``ops/select.candidate_pools``, ``csrc/grid_pool.cu``), K2
(``frontend/stereo_frame.stereo_pairs``, ``csrc/stereo_hamming.cu``) and
K3 (``frontend/stereo_frame.sad_refine``, ``csrc/sad_refine.cu``) bit for
bit against their plain twins on the same card tensors: at the main path's
shapes (`path_inputs`: the 16 score maps of one 752x480 stereo frame of
`stereo_sequence(seed=1)` at 8 levels and 1000 features, the mono
initialisation's 5000-feature call on its left image, and that frame's
features, strips and pair block) and at the edge cases of `k1_cases`,
`k2_cases` and `k3_cases` (seeded numpy inputs: K = 1, K not a multiple
of a block, K = 2000, every slot invalid, rows with no valid pair, ties of
distances and of slides, n_ok = 0 and a single ok slot, odd cells whose
fine cells straddle coarse cells, quotas above the corners, maps that are
views with a row pitch, 32 maps in one launch pair and 40 in two).  Then
it times each kernel at the path's shapes (device time of a CUDA graph of
20 calls, ``utils/device_time.device_ms``) beside its twin, its bound
from this run's inputs and, for K2, the JAX package's formulation of the
distance matrix as torch ops (bits unpacked, one bf16 ``torch.matmul``),
N times.
The last line is a JSON object.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import numpy as np
import torch

H, W, FX, BASELINE, SEED = 480, 752, 435.2, 0.11, 1
WL, WW = 11, 21  # the SAD window and strip widths


def _err(got, want) -> float:
    """Max abs difference of two tensors (or tuples of them); inf where
    values are equal but bits are not (signed zeros)."""
    if isinstance(got, (tuple, list)):
        return max(_err(g, w) for g, w in zip(got, want))
    if got.shape != want.shape or got.dtype != want.dtype:
        return math.inf
    if got.is_floating_point():
        if torch.equal(got.view(torch.int32), want.view(torch.int32)):
            return 0.0
        diff = (got.double() - want.double()).abs().nan_to_num(math.inf)
        return float(diff.max()) or math.inf
    return float((got.long() - want.long()).abs().max()) if got.numel() else 0.0


# --- the main path's inputs ------------------------------------------------


def path_inputs(dev) -> dict:
    """The main path's inputs of each kernel on `dev`: K1's two calls
    (a stereo frame's 16 maps, the mono initialisation's 5000-feature
    call), K2's and K3's arguments on the frame's features."""
    from orbslam3_tpu_torch import FusedKernels, Pinhole, PyramidParams, stereo_sequence
    from orbslam3_tpu_torch.frontend import stereo_frame as sf
    from orbslam3_tpu_torch.ops import extractor as ex
    from orbslam3_tpu_torch.ops.fast import detect_two_threshold_multi
    from orbslam3_tpu_torch.ops.pyramid import build_pyramid

    camera = Pinhole([FX, FX, W / 2, H / 2])
    frames = stereo_sequence(1, camera, BASELINE, H, W, seed=SEED)
    pair = torch.from_numpy(np.stack(frames[0][:2])).to(dev)
    params, mbf = PyramidParams(), FX * BASELINE
    fe = sf.front_end(params, (H, W), mbf, FX, str(dev))

    def selection_call(images, p, tables):
        crops, quotas = [], []
        for img in images:
            active, c = ex.detection_crops(build_pyramid(img, p, tables.resize_taps()), p)
            crops += c
            quotas += [int(p.features_per_level()[l]) for l in active]
        scores = detect_two_threshold_multi(crops, p.ini_th_fast, p.min_th_fast,
                                            mask=tables.det_mask)
        return scores, quotas

    ini = dataclasses.replace(params, n_features=5 * params.n_features)
    x_ini = ex.feature_extractor(ini, (H, W), FusedKernels(), str(dev))
    feat_l, feat_r, comps = sf._extract_pair(pair, params, fe, FusedKernels())
    max_d = mbf / (mbf / FX)
    k2 = (feat_l, feat_r, fe.level_hw, fe.scale_factors, fe.inv_scale_factors,
          (fe.row_off[0], fe.col_off[0]), (fe.row_off[1], fe.col_off[1]), max_d)
    pairs = sf.stereo_pairs_plain(*k2)
    p_l, p_r = sf.sad_strips(comps.bordered, comps.bordered, pairs)
    k3 = (p_l, p_r, pairs, feat_l.xy, feat_l.octave, fe.scale_factors, max_d, mbf)
    return dict(
        k1={"stereo frame": selection_call(list(pair), params, fe),
            "mono init 5000": selection_call([pair[0]], ini, x_ini)},
        k2=k2, k3=k3,
    )


# --- edge cases (seeded numpy inputs) ----------------------------------------


def _sparse(rng, h, w, keep=0.07, hi=60):
    s = rng.integers(0, hi, (h, w)).astype(np.int32)
    s[rng.random((h, w)) >= keep] = 0
    return s


def odd_cell_shape() -> tuple[int, int, int]:
    """(h, w, k) of a map whose coarse cell is odd (>= 3), so its fine
    cells straddle coarse cells."""
    from orbslam3_tpu_torch.ops.select import cell_size_for

    for k in range(5, 400):
        h, w = 97, 131
        if cell_size_for(h, w, k) % 2 == 1 and cell_size_for(h, w, k) >= 3:
            return h, w, k
    raise AssertionError("no odd cell found")


def k1_cases() -> dict:
    """{case: (numpy score maps, quotas)}."""
    rng = np.random.default_rng(SEED)
    shapes = [(208, 288), (176, 240), (142, 197), (113, 157)]
    h, w, k = odd_cell_shape()
    few = np.zeros((80, 100), np.int32)
    few[10, 20] = few[50, 70] = few[30, 30] = 9
    cases = {
        "sparse": ([_sparse(rng, *s) for s in shapes], [217, 181, 151, 126]),
        "all ties 1": ([np.full((64, 96), 1, np.int32), np.full((40, 40), 1, np.int32)], [50, 300]),
        "all ties 37": ([np.full((64, 96), 37, np.int32)], [50]),
        "odd cell": ([_sparse(rng, h, w, keep=0.5), np.full((h, w), 5, np.int32)], [k, k]),
        "quota above corners": ([few, np.zeros((30, 30), np.int32)], [40, 5]),
        "one pixel and one row": ([np.full((1, 1), 3, np.int32), _sparse(rng, 1, 37, 0.5)], [1, 3]),
        "dense": ([rng.integers(0, 256, (120, 160)).astype(np.int32)], [1]),
        "32 maps": ([_sparse(rng, 20 + 3 * i, 30 + 5 * i, 0.2) for i in range(32)],
                    [1 + 7 * i for i in range(32)]),
        "40 maps (two launch pairs)": ([_sparse(rng, 9 + i, 70 - i, 0.3) for i in range(40)],
                                       [3 + 2 * i for i in range(40)]),
    }
    return cases


def _tables(rng, n_levels=8):
    from orbslam3_tpu_torch import PyramidParams

    p = PyramidParams()
    scales = p.scale_factors.astype(np.float32)
    return dict(
        level_hw=np.asarray(p.level_sizes(H, W), np.int32),
        scale=scales, inv=(np.float32(1.0) / scales).astype(np.float32),
        origins_l=(rng.integers(0, 900, n_levels).astype(np.int32),
                   rng.integers(0, 900, n_levels).astype(np.int32)),
        origins_r=(rng.integers(0, 900, n_levels).astype(np.int32),
                   rng.integers(0, 900, n_levels).astype(np.int32)),
    )


def _features(rng, k, like=None, valid=0.9, desc_pool=None, far=False, flip=0.08):
    """numpy (xy, octave, valid, desc) of k slots.  `like` (another
    camera's slots) places them near its keypoints (a disparity of 0-60 px,
    rows within a few px, octaves within one) with its descriptors' bits
    flipped at the rate `flip`; `desc_pool` draws descriptors from that many distinct ones
    (ties); `far` puts them where no pair passes."""
    if like is None:
        xy = np.stack([rng.uniform(0, W, k), rng.uniform(0, H, k)], 1)
        octave = rng.integers(0, 8, k).astype(np.int32)
        desc = rng.integers(0, 256, (k, 32)).astype(np.uint8)
    else:
        src = rng.integers(0, like[0].shape[0], k)
        xy = like[0][src] + np.stack([-rng.uniform(0, 60, k), rng.normal(0, 2, k)], 1)
        octave = np.clip(like[1][src] + rng.integers(-1, 2, k), 0, 7).astype(np.int32)
        flips = np.packbits(rng.random((k, 256)) < flip, axis=1, bitorder="little")
        desc = like[3][src] ^ flips
    if far:
        xy = xy + np.array([0.0, 10 * H])
    xy = np.round(xy * 4) / 4  # quarter pixels: many exact row-band edges
    if desc_pool is not None:
        pool = rng.integers(0, 256, (desc_pool, 32)).astype(np.uint8)
        desc = pool[rng.integers(0, desc_pool, k)]
    return (xy.astype(np.float32), octave, rng.random(k) < valid, desc)


def k2_cases() -> dict:
    """{case: (left, right, tables, max_d)} as numpy."""
    rng = np.random.default_rng(SEED + 1)
    tables = _tables(rng)
    max_d = FX * BASELINE / BASELINE
    cases = {}
    for name, k, kw_l, kw_r in (
        ("K=1", 1, {}, {}),
        ("K=45", 45, {}, {}),
        ("K=1000", 1000, {}, {}),
        ("K=2000", 2000, {}, {}),
        ("ties", 300, dict(desc_pool=3), dict(flip=0.0)),
        ("all invalid", 200, dict(valid=0.0), dict(valid=0.0)),
        ("no valid pair", 200, {}, dict(far=True)),
    ):
        left = _features(rng, k, **kw_l)
        right = _features(rng, k, like=left, **kw_r)
        cases[name] = (left, right, tables, max_d)
    left = _features(rng, 333)
    cases["K_l=333, K_r=77"] = (left, _features(rng, 77, like=left), tables, max_d)
    return cases


def k3_cases() -> dict:
    """{case: (p_l, p_r, pairs, xy_l, oct_l, scale, max_d, mbf)} as numpy."""
    from orbslam3_tpu_torch.frontend.stereo_frame import PAIR_ROW, PAIR_ROWS

    rng = np.random.default_rng(SEED + 2)
    scale = _tables(rng)["scale"]
    mbf = FX * BASELINE
    max_d = mbf / BASELINE

    def make(k, tentative=0.9, periodic=False, flat=False):
        j0 = rng.integers(0, 11, k)
        p_r = rng.integers(0, 256, (k, WL, WW)).astype(np.int32)
        if periodic:  # columns of period 4: slides j0, j0 + 4 (and j0 + 8) tie
            p_r = np.tile(rng.integers(0, 255, (k, WL, 4)), (1, 1, 6))[:, :, :WW]
            j0 = rng.integers(1, 3, k)
        if flat:  # every slide's SAD is equal
            p_r = np.full((k, WL, WW), 17)
        p_l = np.stack([p_r[i, :, j0[i] : j0[i] + WL] for i in range(k)])
        if periodic:  # the tie at a SAD of 121, not 0, so the median keeps it
            p_l = p_l + 1
        elif not flat:
            p_l = np.clip(p_l + rng.integers(-3, 4, p_l.shape), 0, 255)
        oct_l = rng.integers(0, 8, k).astype(np.int32)
        sur0 = rng.integers(20, 600, k)
        ul = scale[oct_l] * (sur0 + j0 - 5) + rng.uniform(-5, 60, k)
        xy = np.stack([ul, rng.uniform(0, H, k)], 1).astype(np.float32)
        pairs = np.zeros((len(PAIR_ROWS), k), np.int32)
        pairs[PAIR_ROW["tentative"]] = rng.random(k) < tentative
        pairs[PAIR_ROW["in_bounds"]] = rng.random(k) < 0.95
        pairs[PAIR_ROW["sur0"]] = sur0
        return (p_l.astype(np.uint8), p_r.astype(np.uint8), pairs, xy, oct_l, scale, max_d, mbf)

    cases = {f"K={k}": make(k) for k in (1, 45, 1000, 2000)}
    cases["n_ok=0"] = make(300, tentative=0.0)
    one = make(300, tentative=0.0)
    one[2][PAIR_ROW["tentative"], 17] = one[2][PAIR_ROW["in_bounds"], 17] = 1
    cases["one ok"] = one
    cases["tied slides"] = make(300, periodic=True)
    cases["flat strips"] = make(64, flat=True)
    return cases


# --- kernel against twin ----------------------------------------------------


def _feat(dev, arrays):
    from orbslam3_tpu_torch.ops.extractor import FrameFeatures

    xy, octave, valid, desc = (torch.from_numpy(np.asarray(a)).to(dev) for a in arrays)
    k = xy.shape[0]
    zeros = torch.zeros(k, dtype=torch.float32, device=dev)
    return FrameFeatures(xy=xy, response=zeros, angle=zeros, octave=octave, size=zeros,
                         valid=valid, desc=desc)


def k2_args(dev, case) -> tuple:
    left, right, t, max_d = case

    def up(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    return (_feat(dev, left), _feat(dev, right), up(t["level_hw"]), up(t["scale"]), up(t["inv"]),
            tuple(map(up, t["origins_l"])), tuple(map(up, t["origins_r"])), max_d)


def k3_args(dev, case) -> tuple:
    *arrays, max_d, mbf = case
    return (*(torch.from_numpy(np.asarray(a)).to(dev) for a in arrays), max_d, mbf)


def k1_edge_errs(dev) -> dict:
    from orbslam3_tpu_torch.ops.select import candidate_pools, candidate_pools_plain

    errs = {}
    for name, (maps, ks) in k1_cases().items():
        scores = [torch.from_numpy(m).to(dev) for m in maps]
        errs[name] = _err(candidate_pools(scores, ks), candidate_pools_plain(scores, ks))
    # maps that are views with a row pitch, as the detection composite gives them
    rng = np.random.default_rng(SEED + 3)
    comp = torch.from_numpy(_sparse(rng, 200, 300)).to(dev)
    views = [comp[3:90, 5:201], comp[100:199, 150:299], comp[0:1, 0:300]]
    errs["views"] = _err(candidate_pools(views, [60, 45, 7]),
                         candidate_pools_plain(views, [60, 45, 7]))
    return errs


def k2_edge_errs(dev) -> dict:
    from orbslam3_tpu_torch.frontend.stereo_frame import stereo_pairs, stereo_pairs_plain

    return {name: _err(stereo_pairs(*k2_args(dev, c)), stereo_pairs_plain(*k2_args(dev, c)))
            for name, c in k2_cases().items()}


def k3_edge_errs(dev) -> dict:
    from orbslam3_tpu_torch.frontend.stereo_frame import sad_refine, sad_refine_plain

    return {name: _err(sad_refine(*k3_args(dev, c)), sad_refine_plain(*k3_args(dev, c)))
            for name, c in k3_cases().items()}


def path_errs(inputs) -> dict:
    """{kernel: {call: max abs err}} of each kernel against its twin on the
    main path's inputs."""
    from orbslam3_tpu_torch.frontend.stereo_frame import (
        sad_refine, sad_refine_plain, stereo_pairs, stereo_pairs_plain,
    )
    from orbslam3_tpu_torch.ops.select import candidate_pools, candidate_pools_plain

    return dict(
        grid_pool={name: _err(candidate_pools(*call), candidate_pools_plain(*call))
                   for name, call in inputs["k1"].items()},
        stereo_hamming={"stereo frame": _err(stereo_pairs(*inputs["k2"]),
                                             stereo_pairs_plain(*inputs["k2"]))},
        sad_refine={"stereo frame": _err(sad_refine(*inputs["k3"]),
                                         sad_refine_plain(*inputs["k3"]))},
    )


# --- bounds -----------------------------------------------------------------

# two-input integer operations: K1 a pixel per pass (the packed value's
# multiply-add and the max), and the winner's two compares where a fine
# pass pixel is not 0; K2 a pair's six band compares and five ANDs, a
# passing pair's XORs and adds beside its eight popcounts; K3 a slot's
# 1331 absolute differences and sums, and the parabola's few
K1_OPS_PER_PX_PASS, K1_OPS_PER_NONZERO = 3, 2
K2_OPS_PER_PAIR, K2_INT_OPS_PER_MATCH, K2_POPC_PER_MATCH = 11, 15, 8
K3_OPS_PER_SLOT = 2 * 11 * 121 + 30


def k1_bound(scores, ks) -> tuple:
    from orbslam3_tpu_torch.ops.select import _grid_of
    from orbslam3_tpu_torch.utils.device_time import bound_ms

    px = sum(s.numel() for s in scores)
    nonzero = sum(int((s != 0).sum()) for s in scores)
    pool = max(_grid_of(*s.shape, k)[2] + k for s, k in zip(scores, ks))
    n_bytes = 4 * px + 16 * len(scores) * pool
    return bound_ms(n_bytes, 2 * K1_OPS_PER_PX_PASS * px + K1_OPS_PER_NONZERO * nonzero)


def k2_bound(args) -> tuple:
    """Bound of K2 on these inputs: the pairs this run's data passes do the
    popcounts (counted at the popcount rate, the rest at the int32 rate)."""
    from orbslam3_tpu_torch.frontend.stereo_frame import PAIR_ROWS
    from orbslam3_tpu_torch.utils.device_time import INT32_OPS_PER_S, POPC_OPS_PER_S, bound_ms

    feat_l, feat_r = args[:2]
    k_l, k_r = feat_l.xy.shape[0], feat_r.xy.shape[0]
    passing = n_passing(args)
    ops = (k_l * k_r * K2_OPS_PER_PAIR + passing * K2_INT_OPS_PER_MATCH
           + passing * K2_POPC_PER_MATCH * INT32_OPS_PER_S / POPC_OPS_PER_S)
    # each slot's xy, octave, validity and descriptor read, the (11, K_l)
    # block written, the level tables read once (a few hundred bytes)
    n_bytes = (k_l + k_r) * (8 + 4 + 1 + 32) + 4 * len(PAIR_ROWS) * k_l
    return bound_ms(n_bytes, ops)


def n_passing(args) -> int:
    """Pairs of K2's inputs that pass the masks (this run's data)."""
    feat_l, feat_r, _, scale, _, _, _, max_d = args
    ul, vl = feat_l.xy[:, 0], feat_l.xy[:, 1]
    ur, vr = feat_r.xy[:, 0], feat_r.xy[:, 1]
    ol, orr = feat_l.octave.long(), feat_r.octave.long()
    r_r = 2.0 * scale[orr]
    row = vl.to(torch.int32).to(torch.float32)
    ok = ((row[:, None] >= torch.floor(vr - r_r)[None])
          & (row[:, None] <= torch.ceil(vr + r_r)[None])
          & (orr[None] >= ol[:, None] - 1) & (orr[None] <= ol[:, None] + 1)
          & (ur[None] >= (ul - max_d)[:, None]) & (ur[None] <= ul[:, None])
          & feat_l.valid[:, None] & feat_r.valid[None])
    return int(ok.sum())


def k3_bound(args) -> tuple:
    from orbslam3_tpu_torch.utils.device_time import bound_ms

    k = args[0].shape[0]
    # strips, the pair block's three rows, ul and octave read; two f32 out
    n_bytes = k * (WL * WL + WL * WW + 12 + 8 + 4 + 8)
    return bound_ms(n_bytes, K3_OPS_PER_SLOT * k)


def hamming_matmul_form(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """The JAX package's distance matrix as torch ops: bits unpacked to
    bf16, one bf16 matmul, |a| + |b| - 2 a.b (for information only)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc_a.device)

    def bits(d):
        return ((d[:, :, None] >> shifts) & 1).reshape(d.shape[0], 256).to(torch.bfloat16)

    ba, bb = bits(desc_a), bits(desc_b)
    ab = torch.matmul(ba, bb.T).to(torch.float32)
    pa, pb = ba.float().sum(1), bb.float().sum(1)
    return (pa[:, None] + pb[None, :] - 2.0 * ab).to(torch.int32)


def time_kernels(inputs, reps: int = 1) -> dict:
    """{kernel: {ms, plain_ms, bound_ms, bound_by, library_ms, ...}} at the
    main path's shapes (device ms a call, medians over `reps` runs)."""
    from orbslam3_tpu_torch.frontend.stereo_frame import (
        sad_refine, sad_refine_plain, stereo_pairs, stereo_pairs_plain,
    )
    from orbslam3_tpu_torch.ops.select import candidate_pools, candidate_pools_plain
    from orbslam3_tpu_torch.utils.device_time import device_ms

    def med(fn):
        return float(np.median([device_ms(fn) for _ in range(reps)]))

    scores, ks = inputs["k1"]["stereo frame"]
    k2, k3 = inputs["k2"], inputs["k3"]
    out = {}
    bound, by = k1_bound(scores, ks)
    out["grid_pool"] = dict(ms=med(lambda: candidate_pools(scores, ks)),
                            plain_ms=med(lambda: candidate_pools_plain(scores, ks)),
                            bound_ms=bound, bound_by=by, library_ms=None)
    ini_scores, ini_ks = inputs["k1"]["mono init 5000"]
    out["grid_pool"]["mono_init_ms"] = med(lambda: candidate_pools(ini_scores, ini_ks))
    bound, by = k2_bound(k2)
    desc_l, desc_r = k2[0].desc, k2[1].desc
    out["stereo_hamming"] = dict(ms=med(lambda: stereo_pairs(*k2)),
                                 plain_ms=med(lambda: stereo_pairs_plain(*k2)),
                                 bound_ms=bound, bound_by=by, library_ms=None,
                                 passing_pairs=n_passing(k2),
                                 jax_form_ms=med(lambda: hamming_matmul_form(desc_l, desc_r)))
    bound, by = k3_bound(k3)
    out["sad_refine"] = dict(ms=med(lambda: sad_refine(*k3)),
                             plain_ms=med(lambda: sad_refine_plain(*k3)),
                             bound_ms=bound, bound_by=by, library_ms=None)
    return out


def main(argv=None) -> int:
    from orbslam3_tpu_torch.tools.card import open_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if open_device("bench_match_kernels", "cuda") is None:
        return 1
    dev = torch.device("cuda")
    inputs = path_inputs(dev)
    exact = dict(path_errs(inputs), k1_edges=k1_edge_errs(dev), k2_edges=k2_edge_errs(dev),
                 k3_edges=k3_edge_errs(dev))
    for group, errs in exact.items():
        print(f"{group}: {errs}", flush=True)
    bad = {g: {k: e for k, e in errs.items() if e != 0} for g, errs in exact.items()}
    bad = {g: v for g, v in bad.items() if v}
    times = time_kernels(inputs, args.reps)
    for name, t in times.items():
        print(f"{name}: {t}", flush=True)
    print(json.dumps(dict(exact=exact, times=times, ok=not bad)))
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
