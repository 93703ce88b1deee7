"""Port fused kernels' twins (B3, B4, B5) == the JAX Pallas kernels, bit-exact.

Each twin is held against the reference's Pallas kernel in interpret mode
on numpy-seeded inputs, on the shapes of the reference's own tests
(tests/test_fast_fused.py, tests/test_window_gather.py), with starts that
exercise the clamp.  The CUDA kernels themselves are held against the
twins on the card by chip_smoke.py; the `cuda` test below runs only where
a card is present."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.ops import fast as jf
from orbslam3_tpu.ops import window_gather as jwg
from orbslam3_tpu.oracle.orb_cpu import ic_moment_weights
from orbslam3_tpu_torch.ops import brief as tb
from orbslam3_tpu_torch.ops import fast as tf
from orbslam3_tpu_torch.tools import bench_window_kernels, score_extremes
from orbslam3_tpu_torch.ops import window_gather as twg


def _rect_mask(h, w, rects):
    mask = np.zeros((h, w), bool)
    for y0, x0, ch, cw in rects:
        mask[y0 + 3 : y0 + ch - 3, x0 + 3 : x0 + cw - 3] = True
    return mask


def _retry_comp():
    # flat image with a few weak corners: ini_th finds nothing in most
    # tiles, so the min_th retry decides the output
    rng = np.random.default_rng(17)
    comp = np.full((64, 256), 120, np.uint8)
    comp[8, 8] = 140
    comp[40, 200] = 250
    comp += rng.integers(0, 3, comp.shape).astype(np.uint8)
    return comp


# name -> (composite, mask, ini_th, min_th)
B3_CASES = {
    "single_level": (
        np.random.default_rng(7).integers(0, 255, (96, 160), np.uint8),
        _rect_mask(96, 160, [(0, 0, 96, 160)]), 20, 7,
    ),
    "single_strip": (
        np.random.default_rng(11).integers(0, 255, (32, 128), np.uint8),
        _rect_mask(32, 128, [(0, 0, 32, 128)]), 20, 7,
    ),
    "multi_level_shelves": (
        np.random.default_rng(13).integers(0, 255, (160, 224), np.uint8),
        _rect_mask(160, 224, [(0, 0, 96, 224), (96, 0, 64, 96), (96, 96, 32, 64)]), 20, 7,
    ),
    "retry_tiles": (_retry_comp(), _rect_mask(64, 256, [(0, 0, 64, 256)]), 60, 7),
    # thresholds at and beyond the ends of the score's range: min_th <= 0
    # keeps zero and negative scores (B3's int16 scratch), ini_th > 254
    # sends every tile to its retry
    **{
        f"extreme_{kind}_{ini_th}_{min_th}": (*score_extremes.b3_case(kind), ini_th, min_th)
        for kind, ini_th, min_th in score_extremes.B3_THRESHOLDS
    },
}


@pytest.mark.parametrize("case", sorted(B3_CASES))
def test_detect_fused_twin_matches_pallas_interpret(case):
    comp, mask, ini_th, min_th = B3_CASES[case]
    want = np.asarray(
        jf._detect_fused_pallas(jnp.asarray(comp), mask, ini_th, min_th, interpret=True)
    )
    got = tf.detect_fused_plain(torch.from_numpy(comp), torch.from_numpy(mask), ini_th, min_th)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "retry_tiles":  # both branches of the retry decide some tile
        assert (want > 0).any()


def test_detect_two_threshold_multi_fused_matches_default_and_jax():
    rng = np.random.default_rng(19)
    crops = [rng.integers(0, 255, hw, np.uint8) for hw in ((96, 160), (72, 120), (48, 80))]
    want = jf.detect_two_threshold_multi([jnp.asarray(c) for c in crops], 20, 7)
    t_crops = [torch.from_numpy(c) for c in crops]
    fused = tf.detect_two_threshold_multi(t_crops, 20, 7, fused=True)
    default = tf.detect_two_threshold_multi(t_crops, 20, 7)
    for f, d, w in zip(fused, default, want):
        np.testing.assert_array_equal(f.numpy(), d.numpy())
        np.testing.assert_array_equal(f.numpy(), np.asarray(w))


def test_detect_fused_wrapper_on_cpu():
    comp, mask, ini_th, min_th = B3_CASES["single_level"]
    comp, mask = torch.from_numpy(comp), torch.from_numpy(mask)
    before = tf.detect_fused.launches
    got = tf.detect_fused(comp, mask, ini_th, min_th)
    assert tf.detect_fused.launches == before  # no kernel launch for a CPU tensor
    assert torch.equal(got, tf.detect_fused_plain(comp, mask, ini_th, min_th))
    bad = mask.clone()
    bad[1, 10] = True
    with pytest.raises(ValueError, match="contract"):
        tf.detect_fused(comp, bad, ini_th, min_th)
    with pytest.raises(ValueError, match="multiples"):
        tf.detect_fused(comp[:90], mask[:90], ini_th, min_th)


def _starts(rng, h, w, nr, nc, k):
    row0 = rng.integers(0, h - nr + 1, k).astype(np.int32)
    col0 = rng.integers(0, w - nc + 1, k).astype(np.int32)
    if k >= 4:  # out-of-bounds starts on both sides of both axes: clamped
        row0[:4] = [-7, h, 3 * h, 0]
        col0[:4] = [w + 5, -3, 0, -10 * w]
    return row0, col0


@pytest.mark.parametrize("k", [1, 9, 64])
def test_window_moments_twin_matches_pallas_interpret(k):
    w10, w01 = ic_moment_weights()
    nr, nc = w10.shape
    nrp = -(-(nr + 16) // 16) * 16
    wp = np.zeros((2, nrp, 128), np.float32)
    wp[0, :nr, :nc] = w10
    wp[1, :nr, :nc] = w01
    rng = np.random.default_rng(11 + k)
    img = rng.integers(0, 256, (213, 331), np.uint8)
    row0, col0 = _starts(rng, 213, 331, nr, nc, k)
    want = np.asarray(
        jwg._window_moments_pallas(
            jnp.asarray(img), jnp.asarray(row0), jnp.asarray(col0), jnp.asarray(wp), nr, nc, True
        )
    )[:, :2]
    weights = torch.from_numpy(np.stack([w10, w01]).astype(np.int32))
    m10, m01 = twg.window_moments_plain(
        torch.from_numpy(img), torch.from_numpy(row0), torch.from_numpy(col0), weights
    )
    assert m10.dtype == torch.float32
    np.testing.assert_array_equal(np.stack([m10.numpy(), m01.numpy()], axis=1), want)


@pytest.mark.parametrize("k,nr,nc,s", [(40, 37, 37, 512), (9, 11, 21, 128), (1, 37, 37, 256)])
def test_sample_windows_twin_matches_pallas_interpret(k, nr, nc, s):
    rng = np.random.default_rng(k * 7 + nr)
    img = rng.integers(0, 256, (213, 331), np.uint8)
    row0, col0 = _starts(rng, 213, 331, nr, nc, k)
    ridx = rng.integers(0, nr, (k, s)).astype(np.int32)
    cidx = rng.integers(0, nc, (k, s)).astype(np.int32)
    want = np.asarray(
        jwg._sample_windows_pallas(
            jnp.asarray(img), jnp.asarray(row0), jnp.asarray(col0),
            jnp.asarray(ridx), jnp.asarray(cidx), nr, nc, True,
        )
    )
    got = twg.sample_windows_plain(
        torch.from_numpy(img), torch.from_numpy(row0), torch.from_numpy(col0),
        torch.from_numpy(ridx), torch.from_numpy(cidx), nr, nc,
    )
    assert got.dtype == torch.uint8 and tuple(got.shape) == (k, s)
    # u8 here, f32 in JAX: the values are equal
    np.testing.assert_array_equal(got.numpy().astype(np.float32), want)


def test_fused_wrappers_on_cpu_use_twins(monkeypatch):
    """On a CPU tensor the fused wrappers run their twins and count no
    launch; the twins go through the plain gather, never the B2 wrapper."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(0, 256, (120, 150), np.uint8))
    r, c = (torch.from_numpy(a) for a in _starts(rng, 120, 150, 37, 37, 16))
    ridx = torch.from_numpy(rng.integers(0, 37, (16, 512)).astype(np.int32))
    cidx = torch.from_numpy(rng.integers(0, 37, (16, 512)).astype(np.int32))
    weights = torch.from_numpy(np.stack(ic_moment_weights()).astype(np.int32))

    def no_b2(*_):
        raise AssertionError("a twin called the B2 wrapper")

    monkeypatch.setattr(twg, "gather_windows", no_b2)
    before = dict(m=twg.window_moments.launches, s=twg.sample_windows.launches,
                  b=tb.brief_descriptors.launches)
    m = twg.window_moments(img, r, c, weights, fused=True)
    want_m = twg.window_moments_plain(img, r, c, weights)
    assert all(torch.equal(a, b) for a, b in zip(m, want_m))
    smp = twg.sample_windows(img, r, c, ridx, cidx, 37, 37, fused=True)
    assert torch.equal(smp, twg.sample_windows_plain(img, r, c, ridx, cidx, 37, 37))
    xy, ang, trig = bench_window_kernels.brief_inputs(rng, 120, 150, 16, "cpu")
    desc = tb.brief_descriptors(img, xy, ang, fused=True)
    assert torch.equal(desc, tb.brief_descriptors_plain(img, xy, ang))
    assert twg.window_moments.launches == before["m"]
    assert twg.sample_windows.launches == before["s"]
    assert tb.brief_descriptors.launches == before["b"]
    with pytest.raises(ValueError):
        twg.sample_windows(img, r, c, ridx[:3], cidx[:3], 37, 37, fused=True)


def test_b5_edge_cases_run_on_cpu():
    """B5's edge cases of tools/bench_window_kernels.py on CPU tensors, where
    both modes take their plain twins: every case present and exact (the
    `cuda` test and chip_smoke.py run them on the card)."""
    index = bench_window_kernels.b5_edge_errs("cpu")
    assert len(index) == 4 * 5 * 4 and not any(index.values())
    brief = bench_window_kernels.brief_edge_errs("cpu")
    assert len(brief) == 4 * 3 and not any(brief.values())


@pytest.mark.cuda
def test_kernels_match_twins_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    for comp, mask, ini_th, min_th in B3_CASES.values():
        c, m = torch.from_numpy(comp).cuda(), torch.from_numpy(mask).cuda()
        got = tf.detect_fused(c, m, ini_th, min_th)
        torch.cuda.synchronize()
        assert torch.equal(got, tf.detect_fused_plain(c, m, ini_th, min_th))
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.integers(0, 256, (213, 331), np.uint8)).cuda()
    r, c = (torch.from_numpy(a).cuda() for a in _starts(rng, 213, 331, 37, 37, 64))
    weights = torch.from_numpy(np.stack(ic_moment_weights()).astype(np.int32)).cuda()
    got = twg.window_moments(img, r, c, weights, fused=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, twg.window_moments_plain(img, r, c, weights)))
    ridx = torch.from_numpy(rng.integers(0, 37, (64, 512)).astype(np.int32)).cuda()
    cidx = torch.from_numpy(rng.integers(0, 37, (64, 512)).astype(np.int32)).cuda()
    got = twg.sample_windows(img, r, c, ridx, cidx, 37, 37, fused=True)
    torch.cuda.synchronize()
    assert torch.equal(got, twg.sample_windows_plain(img, r, c, ridx, cidx, 37, 37))
    # B5's rBRIEF mode: exact with (cos, sin) pinned; with the trig in the
    # kernel, within the C-h2 bound of the twin's torch.cos / torch.sin
    xy, ang, trig = bench_window_kernels.brief_inputs(rng, 213, 331, 500, "cuda")
    got = tb.brief_descriptors(img, xy, ang, trig, fused=True)
    torch.cuda.synchronize()
    assert torch.equal(got, tb.brief_descriptors_plain(img, xy, ang, trig))
    got = tb.brief_descriptors(img, xy, ang, fused=True)
    assert int((got != tb.brief_descriptors_plain(img, xy, ang)).any(1).sum()) <= 5
    for errs in (bench_window_kernels.b5_edge_errs("cuda"),
                 bench_window_kernels.brief_edge_errs("cuda")):
        assert {k: e for k, e in errs.items() if e != 0} == {}
    # B4's edge cases: an image's last byte with h*w % 4 != 0, views 1-3
    # bytes past an aligned base, K = 1 and K not a multiple of 8, and the
    # run-time instantiation's shapes up to 48x128
    errs = bench_window_kernels.b4_edge_errs("cuda")
    assert {k: e for k, e in errs.items() if e != 0} == {}
