"""K2's and K3's plain twins == the JAX package's stereo match, on seeded inputs.

`frontend/stereo_frame.stereo_pairs_plain` (what ``csrc/stereo_hamming.cu``
is held to on the card) against the reference's masks over
`orbslam3_tpu.ops.matching.hamming_matrix` and `jnp.argmin`, with its
rounded strip coordinates, bounds and clipped starts
(``orbslam3_tpu/frontend/stereo_frame.py:86-131``): every row bit for bit.
`sad_refine_plain` (what ``csrc/sad_refine.cu`` is held to) against the
reference's SAD refinement and median filter (``:141-202``, the
(slide, 121, K) bf16 layout, the one-hot lane picks, the sorted median):
op by op, u_right and depth bit for bit; jitted as the reference runs it,
u_right bit for bit and depth within what XLA's FMA contraction of the
disparity's multiply-subtract moves it (ROADMAP §C): the disparity by an
ulp of ul and of best_ur at most, so depth by that over the disparity,
plus its own rounding (on a real frame ~32 ulps; on these cases, whose
disparities reach a few hundredths of a pixel, more).  Inputs are
`tools/bench_match_kernels.k2_cases` / `k3_cases`: K = 1, K not a multiple
of 32, K = 1000 / 2000, distance ties, every slot invalid, rows with no
valid pair, K_l != K_r; n_ok = 0, one ok slot, slides tied at the first
minimum, flat strips.  The kernels against the twins run on the card only
(`cuda`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops.matching import BIG, hamming_matrix
from orbslam3_tpu_torch.frontend import stereo_frame as tsf
from orbslam3_tpu_torch.tools import bench_match_kernels as bmk

K2_CASES = bmk.k2_cases()
K3_CASES = bmk.k3_cases()
SAD_W = SAD_L = 5
ROW = tsf.PAIR_ROW


def jax_pairs(left, right, level_hw, scales, origins_l, origins_r, max_d):
    """The reference's pair match and strip coordinates (stereo_frame.py
    :86-131), table lookups as plain indexing (single contributors: equal
    to its one-hot lane sums)."""
    xy_l, oct_l, valid_l, desc_l = left
    xy_r, oct_r, valid_r, desc_r = right
    inv_scales = 1.0 / scales
    ul, vl = xy_l[:, 0], xy_l[:, 1]
    ur, vr = xy_r[:, 0], xy_r[:, 1]
    row = vl.astype(jnp.int32).astype(jnp.float32)
    r_r = 2.0 * scales[oct_r]
    row_ok = (row[:, None] >= jnp.floor(vr - r_r)[None, :]) & (
        row[:, None] <= jnp.ceil(vr + r_r)[None, :]
    )
    oct_ok = (oct_r[None, :] >= oct_l[:, None] - 1) & (oct_r[None, :] <= oct_l[:, None] + 1)
    u_ok = (ur[None, :] >= (ul - max_d)[:, None]) & (ur[None, :] <= ul[:, None])
    pair_ok = row_ok & oct_ok & u_ok & valid_l[:, None] & valid_r[None, :]
    d = jnp.where(pair_ok, hamming_matrix(desc_l, desc_r), BIG)
    best_r = jnp.argmin(d, axis=1).astype(jnp.int32)
    best_dist = d.min(axis=1)
    tentative = best_dist < 75
    inv = inv_scales[oct_l]
    sul = jnp.round(ul * inv).astype(jnp.int32)
    svl = jnp.round(vl * inv).astype(jnp.int32)
    sur0 = jnp.round(ur[best_r] * inv).astype(jnp.int32)
    lh, lw = level_hw[oct_l, 0], level_hw[oct_l, 1]
    in_bounds = (
        (svl - SAD_W >= 0) & (svl + SAD_W + 1 <= lh)
        & (sul - SAD_W >= 0) & (sul + SAD_W + 1 <= lw)
        & (sur0 - SAD_L - SAD_W >= 0) & (sur0 + SAD_L + SAD_W + 1 <= lw)
    )
    wl, ww = 2 * SAD_W + 1, 2 * (SAD_L + SAD_W) + 1
    cl_svl = jnp.clip(svl - SAD_W, 0, lh - wl)
    cl_sul = jnp.clip(sul - SAD_W, 0, lw - wl)
    cl_sur = jnp.clip(sur0 - SAD_L - SAD_W, 0, lw - ww)
    rows = (best_r, best_dist, tentative, sul, svl, sur0, in_bounds,
            origins_l[0][oct_l] + cl_svl, origins_l[1][oct_l] + cl_sul,
            origins_r[0][oct_l] + cl_svl, origins_r[1][oct_l] + cl_sur)
    return jnp.stack([r.astype(jnp.int32) for r in rows])


def jax_sad(p_l, p_r, tentative, in_bounds, sur0, ul, oct_l, scales, max_d, mbf):
    """The reference's SAD refinement and median filter (stereo_frame.py
    :153-202) on strips as its gather returns them (bf16)."""
    wl, ww = 2 * SAD_W + 1, 2 * (SAD_L + SAD_W) + 1
    k = p_l.shape[0]
    pl2 = jnp.transpose(p_l, (2, 1, 0)).reshape(wl * wl, k)
    pr2 = jnp.transpose(p_r, (2, 1, 0)).reshape(ww * wl, k)
    slides = jnp.stack([
        jax.lax.slice_in_dim(pr2, j * wl, j * wl + wl * wl, axis=0) for j in range(2 * SAD_L + 1)
    ])
    dists = jnp.abs(pl2[None] - slides).sum(axis=1, dtype=jnp.float32).T
    best_j = jnp.argmin(dists, axis=1).astype(jnp.int32)
    sad = dists.min(axis=1)
    inc_ok = (best_j > 0) & (best_j < 2 * SAD_L)
    jm = jnp.clip(best_j, 1, 2 * SAD_L - 1)
    jiota = jax.lax.broadcasted_iota(jnp.int32, dists.shape, 1)

    def at_lane(j):
        return jnp.where(jiota == j[:, None], dists, 0.0).sum(axis=1).astype(jnp.float32)

    d1, d2, d3 = at_lane(jm - 1), at_lane(jm), at_lane(jm + 1)
    denom = 2.0 * (d1 + d3 - 2.0 * d2)
    delta = jnp.where(denom != 0, (d1 - d3) / denom, 0.0)
    delta_ok = (delta >= -1.0) & (delta <= 1.0)
    best_ur = scales[oct_l] * (
        sur0.astype(jnp.float32) + (best_j - SAD_L).astype(jnp.float32) + delta
    )
    disparity = ul - best_ur
    disp_ok = (disparity >= 0.0) & (disparity < max_d)
    clamped = disparity <= 0.0
    disparity = jnp.where(clamped, 0.01, disparity)
    best_ur = jnp.where(clamped, ul - 0.01, best_ur)
    ok = tentative & in_bounds & inc_ok & delta_ok & disp_ok
    n_ok = ok.sum()
    sorted_sad = jnp.sort(jnp.where(ok, sad, BIG))
    median = sorted_sad[jnp.minimum(n_ok // 2, sad.shape[0] - 1)].astype(jnp.float32)
    th = 1.5 * 1.4 * median
    ok = ok & jnp.where(n_ok > 0, sad.astype(jnp.float32) < th, False)
    return jnp.where(ok, best_ur, -1.0), jnp.where(ok, mbf / disparity, -1.0)


JAX_PAIRS = jax.jit(jax_pairs, static_argnums=6)


def _k2_jax(case):
    left, right, t, max_d = case
    j = lambda arrs: tuple(jnp.asarray(a) for a in arrs)  # noqa: E731
    return np.asarray(JAX_PAIRS(j(left), j(right), jnp.asarray(t["level_hw"]),
                                jnp.asarray(t["scale"]), j(t["origins_l"]), j(t["origins_r"]),
                                max_d))


def _k3_jax(case, jit: bool):
    p_l, p_r, pairs, xy, oct_l, scale, max_d, mbf = case
    args = (jnp.asarray(p_l, jnp.bfloat16), jnp.asarray(p_r, jnp.bfloat16),
            jnp.asarray(pairs[ROW["tentative"]] != 0), jnp.asarray(pairs[ROW["in_bounds"]] != 0),
            jnp.asarray(pairs[ROW["sur0"]]), jnp.asarray(xy[:, 0]), jnp.asarray(oct_l),
            jnp.asarray(scale))
    fn = jax.jit(jax_sad, static_argnums=(8, 9)) if jit else jax_sad
    return tuple(np.asarray(a) for a in fn(*args, max_d, mbf))


@pytest.mark.parametrize("case", list(K2_CASES))
def test_pair_twin_matches_jax(case):
    got = tsf.stereo_pairs_plain(*bmk.k2_args("cpu", K2_CASES[case])).numpy()
    want = _k2_jax(K2_CASES[case])
    for name, i in ROW.items():
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)


def test_pair_cases_cover_ties_and_empty_rows():
    """The cases reach what they are named for: tied distances at a row's
    minimum, rows where no pair passes, tentative matches."""
    ties = bmk.k2_args("cpu", K2_CASES["ties"])
    got = tsf.stereo_pairs_plain(*ties)
    from orbslam3_tpu_torch.ops.matching import hamming_matrix as th

    d = th(ties[0].desc, ties[1].desc)
    assert int((d == 0).sum()) > ties[0].desc.shape[0]  # duplicate descriptors
    assert (got[ROW["best_dist"]] == 1 << 15).any() and (got[ROW["best_dist"]] < 1 << 15).any()
    big = tsf.stereo_pairs_plain(*bmk.k2_args("cpu", K2_CASES["K=1000"]))
    assert int(big[ROW["tentative"]].sum()) > 100
    none = tsf.stereo_pairs_plain(*bmk.k2_args("cpu", K2_CASES["no valid pair"]))
    assert bool((none[ROW["best_dist"]] == 1 << 15).all() and (none[ROW["best_r"]] == 0).all())


@pytest.mark.parametrize("case", [c for c in K3_CASES if c != "K=2000"])
def test_sad_twin_matches_jax_op_by_op(case):
    u, d = (t.numpy() for t in tsf.sad_refine_plain(*bmk.k3_args("cpu", K3_CASES[case])))
    wu, wd = _k3_jax(K3_CASES[case], jit=False)
    np.testing.assert_array_equal(u, wu)
    np.testing.assert_array_equal(d, wd)


@pytest.mark.parametrize("case", ["K=1000", "K=2000", "tied slides"])
def test_sad_twin_matches_jax_jitted(case):
    u, d = (t.numpy() for t in tsf.sad_refine_plain(*bmk.k3_args("cpu", K3_CASES[case])))
    wu, wd = _k3_jax(K3_CASES[case], jit=True)
    np.testing.assert_array_equal(u, wu)
    assert ((d < 0) == (wd < 0)).all()
    kept = wd > 0
    ul = K3_CASES[case][3][:, 0]
    mbf = K3_CASES[case][-1]
    disparity = np.float64(np.float32(mbf)) / wd[kept]
    eps = np.finfo(np.float32).eps
    rel = np.abs(d[kept].astype(np.float64) - wd[kept]) / wd[kept]
    bound = eps * (np.abs(ul[kept]) + np.abs(u[kept])) / disparity + 2 * eps
    assert (rel <= bound).all(), (rel / bound).max()
    assert (d != wd).any() or case == "tied slides"  # the contraction shows


def test_sad_cases_cover_what_they_name():
    """n_ok = 0 keeps nothing, one ok slot keeps itself (the median is its
    own SAD), tied slides resolve to the first minimum and keep matches."""
    def run(name):
        return tsf.sad_refine_plain(*bmk.k3_args("cpu", K3_CASES[name]))

    assert bool((run("n_ok=0")[0] == -1).all())
    u, _ = run("one ok")
    assert int((u >= 0).sum()) == 1 and float(u[17]) >= 0
    u, _ = run("tied slides")
    assert int((u >= 0).sum()) > 100
    assert bool((run("flat strips")[0] == -1).all())  # best slide 0: no parabola


def test_wrappers_take_the_twins_on_the_cpu():
    k2 = bmk.k2_args("cpu", K2_CASES["K=45"])
    k3 = bmk.k3_args("cpu", K3_CASES["K=45"])
    before = (tsf.stereo_pairs.launches, tsf.sad_refine.launches)
    assert torch.equal(tsf.stereo_pairs(*k2), tsf.stereo_pairs_plain(*k2))
    for g, w in zip(tsf.sad_refine(*k3), tsf.sad_refine_plain(*k3)):
        assert torch.equal(g, w)
    assert (tsf.stereo_pairs.launches, tsf.sad_refine.launches) == before


def test_wrappers_refuse_other_devices_and_bad_shapes():
    k2 = bmk.k2_args("meta", K2_CASES["K=45"])
    with pytest.raises(ValueError):
        tsf.stereo_pairs(*k2)
    k3 = list(bmk.k3_args("cpu", K3_CASES["K=45"]))
    with pytest.raises(TypeError):
        tsf.sad_refine(k3[0][:, :, :10], *k3[1:])
    with pytest.raises(ValueError):
        tsf.sad_refine(*[a.to("meta") if isinstance(a, torch.Tensor) else a for a in k3])


@pytest.mark.cuda
def test_kernels_match_twins_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    errs = dict(k2=bmk.k2_edge_errs(dev), k3=bmk.k3_edge_errs(dev))
    path = bmk.path_errs(bmk.path_inputs(dev))
    errs.update(path_k2=path["stereo_hamming"], path_k3=path["sad_refine"])
    bad = {g: {k: e for k, e in v.items() if e != 0} for g, v in errs.items()}
    assert not any(bad.values()), bad
