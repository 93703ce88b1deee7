"""Port grid top-K selection == JAX selection, bit-exact, ties included.

`lax.top_k` takes the lower index first among equal keys; the port's
stable sort must pick exactly the same slots (hazard C-h1)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.ops import select as js
from orbslam3_tpu_torch.ops import select as ts


def _compare(scores, ks):
    want = js.select_topk_grid_multi([jnp.asarray(s) for s in scores], ks)
    got = ts.select_topk_grid_multi([torch.from_numpy(s) for s in scores], ks)
    assert len(got) == len(want)
    for (gxy, gr, gv), (wxy, wr, wv) in zip(got, want):
        np.testing.assert_array_equal(gxy.numpy(), np.asarray(wxy))
        np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_cell_size_matches():
    for h, w, k in ((208, 288, 217), (50, 70, 13), (7, 7, 60), (448, 720, 1000)):
        assert ts.cell_size_for(h, w, k) == js.cell_size_for(h, w, k)


def test_select_multi_bit_exact_sparse_maps():
    rng = np.random.default_rng(4)
    shapes = [(208, 288), (176, 240), (142, 197), (113, 157)]
    ks = [217, 181, 151, 126]
    scores = []
    for h, w in shapes:
        s = rng.integers(0, 60, (h, w)).astype(np.int32)
        s[rng.random((h, w)) < 0.93] = 0  # sparse, like NMS'd maps
        scores.append(s)
    _compare(scores, ks)


@pytest.mark.parametrize("value", [1, 37])
def test_select_all_ties(value):
    """Every candidate has the same response: the key ties everywhere, so
    the order is decided by the tie rule alone."""
    scores = [np.full((64, 96), value, np.int32), np.full((40, 40), value, np.int32)]
    _compare(scores, [50, 300])


def test_select_more_quota_than_corners():
    s = np.zeros((80, 100), np.int32)
    s[10, 20] = s[50, 70] = s[30, 30] = 9
    _compare([s, np.zeros((30, 30), np.int32)], [40, 5])
