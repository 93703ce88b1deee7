"""Port window gather (B2 twin) and its compositions == JAX, exact.

The twin is held against the JAX Pallas kernel in interpret mode at the
four window shapes of the main path (31x31 orientation, 37x37 BRIEF, 11x11
and 11x21 SAD), with starts that exercise the clamp.  The CUDA kernel is
held against the twin on the card by chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.ops import window_gather as jwg
from orbslam3_tpu.oracle.orb_cpu import ic_moment_weights
from orbslam3_tpu_torch.ops import window_gather as twg

SHAPES = ((31, 31), (37, 37), (11, 11), (11, 21))


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
