"""K1's plain twin == the JAX package's candidate pool, bit for bit.

`ops/select.candidate_pools_plain` (what ``csrc/grid_pool.cu`` is held to
on the card) returns the pools of several maps stacked to the longest;
row l must equal `orbslam3_tpu.ops.select._candidate_pool` of map l (key,
resp, ys, xs) and hold key -1, resp = ys = xs = 0 beyond it.  The inputs
are `tools/bench_match_kernels.k1_cases`' seeded maps: sparse random maps,
maps where every pixel ties, an odd cell whose fine cells straddle coarse
cells, quotas above the number of corners, one-pixel and one-row maps;
32 and 40 maps in one call are held row by row to each map's own pool.  The
kernel against the twin runs on the card only (`cuda`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import select as js
from orbslam3_tpu_torch.ops import select as ts
from orbslam3_tpu_torch.tools import bench_match_kernels as bmk

CASES = bmk.k1_cases()
# the reference's pool, jitted as the reference runs it (integer ops and an
# exact f32 key: the same bits as op by op)
REF_POOL = jax.jit(js._candidate_pool, static_argnums=1)


def _compare_pools(maps, ks):
    got = [t.numpy() for t in ts.candidate_pools_plain([torch.from_numpy(m) for m in maps], ks)]
    pool = got[0].shape[1]
    for l, (m, k) in enumerate(zip(maps, ks)):
        want = [np.asarray(a) for a in REF_POOL(jnp.asarray(m), k)]
        n = want[0].shape[0]
        assert n <= pool
        for g, w, fill in zip(got, want, (-1.0, 0, 0, 0)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g[l, :n], w)
            assert (g[l, n:] == fill).all()


MANY = ("32 maps", "40 maps (two launch pairs)")


@pytest.mark.parametrize("case", sorted(set(CASES) - set(MANY)))
def test_pool_twin_matches_jax(case):
    _compare_pools(*CASES[case])


@pytest.mark.parametrize("case", MANY)
def test_pool_twin_stacks_each_maps_own_pool(case):
    """Many maps in one call: row l is map l's pool alone, padded (the
    per-map pools are held to the reference above)."""
    maps, ks = CASES[case]
    scores = [torch.from_numpy(m) for m in maps]
    got = ts.candidate_pools_plain(scores, ks)
    for l in range(0, len(maps), 5):
        alone = ts.candidate_pools_plain(scores[l : l + 1], ks[l : l + 1])
        n = alone[0].shape[1]
        for g, a, fill in zip(got, alone, (-1.0, 0, 0, 0)):
            assert torch.equal(g[l, :n], a[0]) and bool((g[l, n:] == fill).all())


def test_odd_cell_straddles():
    """The odd-cell case really has fine cells across coarse cell edges."""
    h, w, k = bmk.odd_cell_shape()
    cell = ts.cell_size_for(h, w, k)
    fine = max(cell // 2, 1)
    assert cell % 2 == 1 and cell % fine != 0


def test_pool_twin_on_views_with_a_row_pitch():
    """Maps that are slices of one composite, as detection returns them."""
    rng = np.random.default_rng(7)
    comp = bmk._sparse(rng, 120, 200)
    views = [(slice(3, 70), slice(5, 131)), (slice(60, 119), slice(100, 199))]
    t = torch.from_numpy(comp)
    got = ts.candidate_pools_plain([t[v] for v in views], [40, 25])
    want = ts.candidate_pools_plain([torch.from_numpy(comp[v].copy()) for v in views], [40, 25])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _compare_pools([comp[v].copy() for v in views], [40, 25])


def test_candidate_pools_takes_the_twin_on_the_cpu():
    maps, ks = CASES["sparse"]
    scores = [torch.from_numpy(m) for m in maps]
    before = ts.candidate_pools.launches
    for g, w in zip(ts.candidate_pools(scores, ks), ts.candidate_pools_plain(scores, ks)):
        assert torch.equal(g, w)
    assert ts.candidate_pools.launches == before


def test_candidate_pools_refuses_other_devices_and_bad_calls():
    with pytest.raises(ValueError):
        ts.candidate_pools([torch.zeros((4, 4), dtype=torch.int32, device="meta")], [2])
    with pytest.raises(ValueError):
        ts.candidate_pools([torch.zeros((4, 4), dtype=torch.int32)], [2, 3])
    with pytest.raises(ValueError):
        ts.candidate_pools([torch.zeros((0, 4), dtype=torch.int32)], [2])


@pytest.mark.cuda
def test_kernel_matches_twin_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    errs = bmk.k1_edge_errs(torch.device("cuda"))
    assert not {k: e for k, e in errs.items() if e != 0}, errs
    path = bmk.path_errs(bmk.path_inputs(torch.device("cuda")))["grid_pool"]
    assert not {k: e for k, e in path.items() if e != 0}, path
