"""The port's stereo program on a geometry that is not flat, and its batch
forms, against the JAX package and against the port's per-frame program.

A geometry that is not flat (120x160 with 1000 features: the top level is
inactive and the upper levels hold fewer candidates than their quota)
takes the per-camera `_extract_single` and still matches on the
camera-merged composite.  Against the reference it is held to the
tolerances of tests/test_torch_stereo.py with platform trig, and with trig
pinned (`test_torch_extractor.pin_trig_jit`) every column is equal but depth,
which XLA's contracted division moves by a few f32 ulps
(tests/test_torch_host_parity.py).  The batch program's row b equals the
per-frame program on pairs[b] bit for bit (as tests/test_stereo.py holds
the reference's), `extract_and_match_stereo_sequence` stacks the
per-frame leaves, and `System.prefetch_stereo_batch` handles reproduce
`track_stereo` exactly."""

import jax
import numpy as np
import pytest
import torch

from orbslam3_tpu.frontend import stereo_frame as jsf
from orbslam3_tpu.oracle.orb_cpu import PyramidParams
from orbslam3_tpu_torch import Pinhole, PyramidParams as TPyramidParams, stereo_sequence
from orbslam3_tpu_torch.frontend import stereo_frame as tsf
from orbslam3_tpu_torch.ops.extractor import active_levels, is_flat
from orbslam3_tpu_torch.slam.system import System
from test_stereo import MBF, FX, shifted_pair
from test_torch_extractor import pin_trig_jit

NON_FLAT_HW = (120, 160)
NON_FLAT = PyramidParams()
TNON_FLAT = TPyramidParams()
BATCH = PyramidParams(n_features=120)  # tests/test_stereo.py's batch check
TBATCH = TPyramidParams(n_features=120)


@pytest.fixture(scope="module")
def non_flat_pair():
    cam = Pinhole([150.0, 150.0, 80.0, 60.0])
    return np.stack(stereo_sequence(1, cam, 0.12, *NON_FLAT_HW, seed=1)[0][:2])


@pytest.fixture(scope="module")
def batch_pairs(small_image):
    """tests/test_stereo.py's three noisy shifted pairs."""
    rng = np.random.default_rng(7)
    pairs = []
    for s in (4, 7, 11):
        img = np.clip(
            small_image.astype(np.int32) + rng.integers(-6, 7, small_image.shape), 0, 255
        ).astype(np.uint8)
        pairs.append(shifted_pair(img, s))
    return np.stack(pairs)


def assert_agree(got: np.ndarray, want: np.ndarray) -> None:
    """tests/test_torch_stereo.py's tolerances."""
    assert got.shape == want.shape
    for col in (0, 1, 2, 4, 5):  # x, y, response, octave, valid
        np.testing.assert_array_equal(got[:, col], want[:, col])
    d = np.abs(got[:, 3] - want[:, 3])
    assert np.minimum(d, 360 - d).max() < 1e-3
    bits = np.unpackbits(got[:, 8:].astype(np.uint8) ^ want[:, 8:].astype(np.uint8), axis=1)
    bits = bits.sum(axis=1)
    assert int((bits > 0).sum()) <= max(5, len(bits) // 100)
    assert bits.max() <= 4
    valid = want[:, 5] > 0.5
    for col in (6, 7):  # u_right, depth
        agree = np.abs(got[:, col] - want[:, col]) <= 1e-5 * np.abs(want[:, col])
        assert agree[valid].mean() >= 0.99, (col, agree[valid].mean())


def test_geometry_is_not_flat():
    sizes = TNON_FLAT.level_sizes(*NON_FLAT_HW)
    assert not is_flat(sizes, TNON_FLAT, active_levels(sizes, TNON_FLAT))
    fe = tsf.StereoFrontEnd.from_reference(TNON_FLAT, NON_FLAT_HW)
    buffers = dict(fe.named_buffers())
    assert "merged_mask" in buffers and "row_off" in buffers and "slot_scale" not in buffers


def test_non_flat_stereo_matches_reference(non_flat_pair):
    want = np.asarray(jsf.extract_and_match_stereo_packed(non_flat_pair, NON_FLAT, MBF, FX))
    got = tsf.extract_and_match_stereo_packed(
        torch.from_numpy(non_flat_pair), TNON_FLAT, MBF, FX
    ).numpy()
    assert (want[:, 5] > 0.5).sum() > 500 and (want[:, 7] > 0).sum() > 100
    assert_agree(got, want)


def test_non_flat_stereo_exact_with_pinned_trig(non_flat_pair, monkeypatch):
    pin_trig_jit(monkeypatch)
    ref_fn = jax.jit(jsf._extract_and_match_stereo_impl, static_argnums=(1, 2, 3))
    ref = jax.tree.map(np.asarray, ref_fn(non_flat_pair, NON_FLAT, MBF, FX))
    out = tsf.extract_and_match_stereo(torch.from_numpy(non_flat_pair), TNON_FLAT, MBF, FX)
    for side, got, want in (("left", out.left, ref.left), ("right", out.right, ref.right)):
        for name in got._fields:
            g, w = getattr(got, name).numpy(), getattr(want, name)
            assert g.dtype == w.dtype, (side, name)
            np.testing.assert_array_equal(g, w, err_msg=f"{side} {name}")
    np.testing.assert_array_equal(out.u_right.numpy(), ref.u_right)
    depth = out.depth.numpy()
    ulps = np.abs(depth.view(np.int32) - ref.depth.view(np.int32))
    assert ulps.max() <= 64 and np.array_equal(depth > 0, ref.depth > 0)
    assert (depth > 0).sum() > 100


@pytest.mark.parametrize("geometry", ["flat", "non_flat"])
def test_packed_batch_rows_equal_per_frame(geometry, batch_pairs, non_flat_pair):
    if geometry == "flat":
        pairs, params = torch.from_numpy(batch_pairs), TBATCH
    else:
        pairs, params = torch.from_numpy(np.stack([non_flat_pair, non_flat_pair[::-1]])), TNON_FLAT
    got = tsf.extract_and_match_stereo_packed_batch(pairs, params, MBF, FX)
    assert got.shape == (len(pairs), params.n_features, tsf.PACK_COLS)
    for b, pair in enumerate(pairs):
        want = tsf.extract_and_match_stereo_packed(pair, params, MBF, FX)
        assert torch.equal(got[b], want), f"batch row {b} != per-frame result"


def test_packed_batch_matches_reference_batch(batch_pairs):
    want = np.asarray(jsf.extract_and_match_stereo_packed_batch(batch_pairs, BATCH, MBF, FX))
    got = tsf.extract_and_match_stereo_packed_batch(
        torch.from_numpy(batch_pairs), TBATCH, MBF, FX
    ).numpy()
    assert got.shape == want.shape
    for g, w in zip(got, want):
        assert_agree(g, w)


def test_sequence_stacks_per_frame_features(batch_pairs):
    pairs = torch.from_numpy(batch_pairs)
    seq = tsf.extract_and_match_stereo_sequence(pairs, TBATCH, MBF, FX)
    assert seq.left.xy.shape == (len(pairs), TBATCH.n_features, 2)
    for b, pair in enumerate(pairs):
        one = tsf.extract_and_match_stereo(pair, TBATCH, MBF, FX)
        for got, want in ((seq.left, one.left), (seq.right, one.right)):
            for name in got._fields:
                assert torch.equal(getattr(got, name)[b], getattr(want, name)), name
        assert torch.equal(seq.u_right[b], one.u_right) and torch.equal(seq.depth[b], one.depth)


@pytest.mark.parametrize("window", [4, 3])
def test_system_batched_prefetch_matches_synchronous(window):
    """Windows of B frames (3: a shorter tail window), handles consumed in
    order: the poses of track_stereo, bit for bit, and the same map."""
    camera = Pinhole([250.0, 250.0, 160.0, 120.0])
    frames = stereo_sequence(4, camera, 0.12, 240, 320, seed=5)
    s_sync = System(camera, 30.0, TPyramidParams(n_features=600), device="cpu")
    s_b = System(camera, 30.0, TPyramidParams(n_features=600), device="cpu")
    handles = []
    for i in range(0, len(frames), window):
        handles += s_b.prefetch_stereo_batch([(il, ir) for il, ir, _ in frames[i : i + window]])
    assert len(handles) == len(frames)
    for k, (il, ir, _) in enumerate(frames):
        p_sync = s_sync.track_stereo(il, ir, k / 20.0)
        p_b = s_b.track_stereo_prefetched(handles[k], k / 20.0)
        assert (p_sync is None) == (p_b is None)
        if p_sync is not None:
            np.testing.assert_array_equal(p_sync.matrix(), p_b.matrix())
    assert s_sync.map_stats() == s_b.map_stats()


@pytest.mark.cuda
def test_batch_on_card_equals_per_frame_and_cpu(batch_pairs, non_flat_pair):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py phases 15 and 16 run this check on the H100")
    for pairs, params in ((batch_pairs, TBATCH), (non_flat_pair[None], TNON_FLAT)):
        card = torch.from_numpy(pairs).cuda()
        got = tsf.extract_and_match_stereo_packed_batch(card, params, MBF, FX)
        for b in range(len(pairs)):
            assert torch.equal(got[b], tsf.extract_and_match_stereo_packed(card[b], params, MBF, FX))
            cpu = tsf.extract_and_match_stereo_packed(torch.from_numpy(pairs[b]), params, MBF, FX)
            for col in (0, 1, 2, 4, 5):
                assert torch.equal(got[b, :, col].cpu(), cpu[:, col])
