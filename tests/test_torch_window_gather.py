"""Port window gather (B2 twin) and its compositions == JAX, exact.

The twin is held against the JAX Pallas kernel in interpret mode at the
four window shapes of the main path (31x31 orientation, 37x37 BRIEF, 11x11
and 11x21 SAD), with starts that exercise the clamp, and so is
`gather_windows_many` on the path's two pairs of jobs (one B2 launch each
on the card).  The CUDA kernel is held against the twin on the card by
chip_smoke.py and by the `cuda` test below, at the main path's shapes and
the edge cases of orbslam3_tpu_torch/tools/bench_window_kernels.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.ops import window_gather as jwg
from orbslam3_tpu.oracle.orb_cpu import ic_moment_weights
from orbslam3_tpu_torch.ops import window_gather as twg
from orbslam3_tpu_torch.tools import bench_window_kernels as bwk

SHAPES = ((31, 31), (37, 37), (11, 11), (11, 21))
# the main path's B2 launches of one stereo frame: two jobs each
PAIRS = {"orient+brief": ((31, 31), (37, 37)), "sad": ((11, 11), (11, 21))}


def _img(seed=11, hw=(213, 331)):
    return np.random.default_rng(seed).integers(0, 256, hw, np.uint8)


@pytest.mark.parametrize("nr,nc", SHAPES)
def test_twin_matches_pallas_interpret(nr, nc):
    img = _img()
    rng = np.random.default_rng(nr * 100 + nc)
    k = 24
    row0 = rng.integers(0, 213 - nr + 1, k).astype(np.int32)
    col0 = rng.integers(0, 331 - nc + 1, k).astype(np.int32)
    # out-of-bounds starts on both sides of both axes: clamped into the image
    row0[:4] = [-7, 213, 500, 0]
    col0[:4] = [400, -3, 0, -1000]
    want = np.asarray(
        jwg._gather_windows_pallas(
            jnp.asarray(img), jnp.asarray(row0), jnp.asarray(col0), nr, nc, True
        )
    )
    got = twg.gather_windows_plain(
        torch.from_numpy(img), torch.from_numpy(row0), torch.from_numpy(col0), nr, nc
    )
    assert got.dtype == torch.uint8 and tuple(got.shape) == (k, nr, nc)
    # u8 here, bf16 in JAX: the values are equal
    np.testing.assert_array_equal(got.numpy().astype(np.float32), want.astype(np.float32))


def test_wrapper_uses_twin_on_cpu():
    img = torch.from_numpy(_img())
    r = torch.tensor([0, 5, 300], dtype=torch.int32)
    c = torch.tensor([-2, 7, 9], dtype=torch.int32)
    before = twg.gather_windows.launches
    out = twg.gather_windows(img, r, c, 11, 21)
    assert twg.gather_windows.launches == before
    assert torch.equal(out, twg.gather_windows_plain(img, r, c, 11, 21))
    with pytest.raises(ValueError):
        twg.gather_windows(img, r, c, 300, 21)


def _pallas(img, row0, col0, nr, nc):
    return np.asarray(
        jwg._gather_windows_pallas(
            jnp.asarray(img), jnp.asarray(row0), jnp.asarray(col0), nr, nc, True
        )
    ).astype(np.float32)


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_many_matches_twin_and_pallas_interpret(pair):
    """One job per window shape of the pair, each on its own image (as
    orientation reads the raw composite and BRIEF the sampling one): each
    output == the plain twin == the Pallas kernel; no launch on the CPU."""
    imgs = [_img(11), _img(12)]
    rng = np.random.default_rng(len(pair))
    k = 19
    jobs = []
    for img, (nr, nc) in zip(imgs, PAIRS[pair]):
        r, c = bwk.starts(rng, *img.shape, nr, nc, k, "cpu")
        jobs.append((torch.from_numpy(img), r, c, nr, nc))
    before = twg.gather_windows.launches
    outs = twg.gather_windows_many(jobs)
    assert twg.gather_windows.launches == before
    assert len(outs) == 2
    for (img, r, c, nr, nc), got in zip(jobs, outs):
        assert got.dtype == torch.uint8 and tuple(got.shape) == (k, nr, nc)
        assert torch.equal(got, twg.gather_windows_plain(img, r, c, nr, nc))
        want = _pallas(img.numpy(), r.numpy(), c.numpy(), nr, nc)
        np.testing.assert_array_equal(got.numpy().astype(np.float32), want)


def test_many_rejects_jobs_that_do_not_share_a_launch():
    img = torch.from_numpy(_img())
    r = torch.tensor([0, 5, 300], dtype=torch.int32)
    c = torch.tensor([-2, 7, 9], dtype=torch.int32)
    assert twg.gather_windows_many([]) == []
    with pytest.raises(ValueError, match="share K"):
        twg.gather_windows_many([(img, r, c, 11, 11), (img, r[:2], c[:2], 11, 21)])
    meta = torch.empty(img.shape, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="one device"):
        twg.gather_windows_many([(img, r, c, 11, 11), (meta, r.to("meta"), c.to("meta"), 11, 21)])
    with pytest.raises(ValueError, match="at most"):
        twg.gather_windows_many([(img, r, c, 11, 11)] * (twg.MAX_JOBS + 1))
    with pytest.raises(ValueError, match="does not fit"):
        twg.gather_windows_many([(img, r, c, 11, 11), (img, r, c, 300, 21)])


def test_moments_and_samples_of_gathered_windows():
    """window_moments and sample_windows over windows gathered already give
    what they give over the image, and refuse a block of the wrong shape."""
    img = torch.from_numpy(_img(5))
    rng = np.random.default_rng(6)
    r, c = bwk.starts(rng, 213, 331, 37, 37, 30, "cpu")
    wins = twg.gather_windows(img, r, c, 37, 37)
    weights = torch.from_numpy(rng.integers(-15, 16, (2, 37, 37)).astype(np.int32))
    for a, b in zip(twg.window_moments(wins, r, c, weights), twg.window_moments(img, r, c, weights)):
        assert torch.equal(a, b)
    ridx = torch.from_numpy(rng.integers(0, 37, (30, 64)).astype(np.int32))
    cidx = torch.from_numpy(rng.integers(0, 37, (30, 64)).astype(np.int32))
    assert torch.equal(twg.sample_windows(wins, r, c, ridx, cidx, 37, 37),
                       twg.sample_windows(img, r, c, ridx, cidx, 37, 37))
    with pytest.raises(ValueError, match="gathered already"):
        twg.sample_windows(wins[:, :31], r, c, ridx, cidx, 37, 37)


def test_edge_case_lists_run_on_cpu():
    """The edge cases the card runs (tools/bench_window_kernels.py) are
    valid jobs: on the CPU the wrappers take the twins, so every case
    agrees, and no launch is counted."""
    before = (twg.gather_windows.launches, twg.window_moments.launches)
    b2, b4 = bwk.b2_edge_errs("cpu"), bwk.b4_edge_errs("cpu")
    assert len(b2) == 102 and len(b4) == 60
    assert set(b2.values()) == {0.0} and set(b4.values()) == {0.0}
    assert (twg.gather_windows.launches, twg.window_moments.launches) == before


def test_window_moments_exact():
    img = _img(3)
    rng = np.random.default_rng(5)
    row0 = rng.integers(0, 213 - 31 + 1, 64).astype(np.int32)
    col0 = rng.integers(0, 331 - 31 + 1, 64).astype(np.int32)
    w10, w01 = ic_moment_weights()
    want10, want01 = jwg.window_moments(
        jnp.asarray(img), jnp.asarray(row0), jnp.asarray(col0),
        w10.astype(np.float32), w01.astype(np.float32),
    )
    weights = torch.from_numpy(np.stack([w10, w01]).astype(np.int32))
    m10, m01 = twg.window_moments(
        torch.from_numpy(img), torch.from_numpy(row0), torch.from_numpy(col0), weights
    )
    np.testing.assert_array_equal(m10.numpy(), np.asarray(want10))
    np.testing.assert_array_equal(m01.numpy(), np.asarray(want01))


def test_sample_windows_exact():
    img = _img(7)
    rng = np.random.default_rng(8)
    k, s = 40, 512
    row0 = rng.integers(-3, 213 - 37 + 4, k).astype(np.int32)
    col0 = rng.integers(-3, 331 - 37 + 4, k).astype(np.int32)
    ridx = rng.integers(0, 37, (k, s)).astype(np.int32)
    cidx = rng.integers(0, 37, (k, s)).astype(np.int32)
    want = np.asarray(
        jwg.sample_windows(
            jnp.asarray(img), jnp.asarray(row0), jnp.asarray(col0),
            jnp.asarray(ridx), jnp.asarray(cidx), 37, 37,
        )
    )
    got = twg.sample_windows(
        torch.from_numpy(img), torch.from_numpy(row0), torch.from_numpy(col0),
        torch.from_numpy(ridx), torch.from_numpy(cidx), 37, 37,
    )
    np.testing.assert_array_equal(got.numpy().astype(np.float32), want)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    img = torch.from_numpy(_img()).cuda()
    for nr, nc in SHAPES:
        r = torch.arange(-20, 240, 10, dtype=torch.int32, device="cuda")
        c = torch.arange(-30, 360, 15, dtype=torch.int32, device="cuda")
        got = twg.gather_windows(img, r, c, nr, nc)
        torch.cuda.synchronize()
        assert torch.equal(got, twg.gather_windows_plain(img, r, c, nr, nc))
    # the path's pairs, one launch each, and the edge cases
    images = {"bordered": img, "sampling": torch.from_numpy(_img(12)).cuda()}
    for jobs in bwk.path_jobs(images).values():
        before = twg.gather_windows.launches
        outs = twg.gather_windows_many(jobs)
        assert twg.gather_windows.launches == before + 1
        torch.cuda.synchronize()
        assert all(torch.equal(o, twg.gather_windows_plain(*job)) for o, job in zip(outs, jobs))
    errs = bwk.b2_edge_errs("cuda")
    assert {k: e for k, e in errs.items() if e != 0} == {}
    assert bwk.b2_grid_mix_err("cuda") == 0


def test_least_read_counts_are_unions():
    """The bounds' byte counts (tools/bench_window_kernels.py): the distinct
    image bytes that windows cover, an image read by two jobs counted once,
    and that B5's picks read, against a mask painted window by window."""
    rng = np.random.default_rng(9)
    a, b = torch.from_numpy(_img(1)), torch.from_numpy(_img(2, (40, 57)))
    jobs = []
    for img, (nr, nc), k in ((a, (31, 31), 40), (a, (11, 21), 25), (b, (37, 37), 9)):
        jobs.append((img, *bwk.starts(rng, *img.shape, nr, nc, k, "cpu"), nr, nc))
    masks = {id(a): np.zeros(a.shape, bool), id(b): np.zeros(b.shape, bool)}
    for img, r, c, nr, nc in jobs:
        h, w = img.shape
        for r0, c0 in zip(r.clamp(0, h - nr).tolist(), c.clamp(0, w - nc).tolist()):
            masks[id(img)][r0 : r0 + nr, c0 : c0 + nc] = True
    assert bwk.covered_bytes(jobs) == sum(int(m.sum()) for m in masks.values())
    _, r, c, nr, nc = jobs[0]
    ridx = torch.from_numpy(rng.integers(0, nr, (40, 64)).astype(np.int32))
    cidx = torch.from_numpy(rng.integers(0, nc, (40, 64)).astype(np.int32))
    seen = np.zeros(a.shape, bool)
    for k, (r0, c0) in enumerate(zip(r.clamp(0, 213 - nr).tolist(), c.clamp(0, 331 - nc).tolist())):
        seen[r0 + ridx[k].numpy(), c0 + cidx[k].numpy()] = True
    assert bwk.picked_bytes(a, r, c, ridx, cidx, nr, nc) == int(seen.sum())
