"""Port stereo front-end == JAX stereo front-end on a synthetic pair.

Integer-derived columns (x, y, response, octave, valid) must be equal.
Angles: within 1e-3 degrees (atan2 ulps, C-h2).  Descriptors: the trig
bound of tests/test_brief.py (<= 1 % differ, <= 4 bits each).  u_right and
depth: equal to 1e-5 relative on >= 99 % of valid slots — a flipped
descriptor bit may change a match, and XLA's CPU code generation may
contract the disparity's multiply-subtract into one fused multiply-add,
which moves depth by an ulp."""

import numpy as np
import pytest
import torch

from orbslam3_tpu.cameras.models import Pinhole
from orbslam3_tpu.frontend import stereo_frame as jsf
from orbslam3_tpu.oracle.orb_cpu import PyramidParams
from orbslam3_tpu.utils.synth import stereo_sequence
from orbslam3_tpu_torch import PyramidParams as TPyramidParams
from orbslam3_tpu_torch.frontend import stereo_frame as tsf

H, W = 240, 320
FX = 300.0
MBF = FX * 0.12
PARAMS = PyramidParams(n_features=500)
TPARAMS = TPyramidParams(n_features=500)  # the port's own class


@pytest.fixture(scope="module")
def packed():
    frames = stereo_sequence(1, Pinhole([FX, FX, W / 2, H / 2]), 0.12, H, W, seed=1)
    pair = np.stack(frames[0][:2])
    want = np.asarray(jsf.extract_and_match_stereo_packed(pair, PARAMS, MBF, FX))
    got = tsf.extract_and_match_stereo_packed(torch.from_numpy(pair), TPARAMS, MBF, FX)
    return pair, want, got.numpy()


def assert_front_ends_agree(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape == (PARAMS.n_features, tsf.PACK_COLS)
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


def test_packed_front_end_matches_jax(packed):
    _, want, got = packed
    assert (want[:, 5] > 0.5).sum() > 400
    assert (want[:, 7] > 0).sum() > 100  # the matcher does find stereo depth
    assert_front_ends_agree(got, want)


def test_unpack_host_features_identical(packed):
    _, want, got = packed
    a, b = tsf.unpack_host_features(want), jsf.unpack_host_features(want)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


def test_extract_from_pyramids_matches_packed_block(packed):
    """The extractor driven step by step with the front-end's tables gives
    the left block of the packed front-end, exactly."""
    from orbslam3_tpu_torch.ops import extractor as ex
    from orbslam3_tpu_torch.ops.fast import detect_two_threshold_multi
    from orbslam3_tpu_torch.ops.pyramid import build_pyramid

    pair, _, got = packed
    tables = tsf.front_end(TPARAMS, (H, W), MBF, FX, "cpu")
    pyrs = [build_pyramid(torch.from_numpy(pair[i]), TPARAMS) for i in range(2)]
    det = [ex.detection_crops(p, TPARAMS) for p in pyrs]
    maps = detect_two_threshold_multi(det[0][1] + det[1][1], 20, 7)
    n = len(det[0][0])
    left, _ = ex.extract_from_pyramids(
        pyrs, TPARAMS, [dict(zip(det[0][0], maps[:n])), dict(zip(det[1][0], maps[n:]))], tables
    )
    np.testing.assert_array_equal(left.xy.numpy(), got[:, 0:2])
    np.testing.assert_array_equal(left.angle.numpy(), got[:, 3])
    np.testing.assert_array_equal(left.desc.numpy(), got[:, 8:].astype(np.uint8))


def test_non_flat_geometry_raises():
    """A geometry that is not flat (64x80, 50 features: five of eight
    levels inactive) raises no more: the front-end builds, runs each
    camera through `_extract_single` and matches on the merged composite
    (tests/test_torch_batch.py holds it against the reference)."""
    fe = tsf.StereoFrontEnd.from_reference(TPyramidParams(n_features=50), (64, 80))
    assert "slot_scale" not in dict(fe.named_buffers())
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (64, 80), dtype=np.uint8)
    out = fe(torch.from_numpy(np.stack([img, np.roll(img, -4, axis=1)])))
    assert tuple(out.shape) == (50, tsf.PACK_COLS)
    valid = out[:, 5] > 0.5
    assert valid.sum() > 0 and (out[valid, 4] <= 2).all()  # only levels 0-2 are active
