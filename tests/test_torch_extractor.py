"""Port `extract_features` == the JAX package's `extract_features_jit`.

On a flat geometry (every level at its full quota: the merged-composite
path) and on one that is not flat (64x96, whose top levels are inactive:
the per-level `_extract_single`), under the default configuration and
under `FusedKernels(True, True, True)`.  Integer columns (xy, response,
octave, size, valid) must be equal.  With platform trig, angles agree to
1e-3 degrees and descriptors stay inside the bound of tests/test_brief.py
(at most 1 % differ, by at most 4 bits).  With the trig pinned in both
packages (atan2 of the exact moments and cos/sin computed in numpy),
angles and descriptors must be equal too."""

import dataclasses

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.ops import brief as jb
from orbslam3_tpu.ops import extractor as jex
from orbslam3_tpu.ops import orientation as jo
from orbslam3_tpu.oracle.orb_cpu import HALF_PATCH_SIZE, PyramidParams
from orbslam3_tpu_torch import FusedKernels, PyramidParams as TPyramidParams
from orbslam3_tpu_torch.ops import brief as tb
from orbslam3_tpu_torch.ops import extractor as tex
from orbslam3_tpu_torch.ops import window_gather as twg

# name -> (image (h, w), params, flat)
GEOMETRIES = {
    "flat_240x320": ((240, 320), PyramidParams(n_features=500), True),
    "non_flat_64x96": ((64, 96), PyramidParams(), False),
}
CONFIGS = {"default": FusedKernels(), "fused": FusedKernels(True, True, True)}


def _image(h, w, seed=4):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 120 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0) + rng.normal(0, 20, (h, w))
    return img.clip(0, 255).astype(np.uint8)


def _port(geometry, config):
    hw, params, flat = GEOMETRIES[geometry]
    params = TPyramidParams(**dataclasses.asdict(params))  # the port's own class
    fe = tex.FeatureExtractor.from_reference(params, hw, CONFIGS[config])
    assert ("slot_scale" in dict(fe.named_buffers())) == flat  # the flat path's tables
    return fe(torch.from_numpy(_image(*hw)))


def _assert_integer_columns_equal(got, want):
    assert got.xy.shape == np.asarray(want.xy).shape
    for name in ("xy", "response", "octave", "size", "valid"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert np.asarray(want.valid).sum() > 50


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_extract_features_matches_jax(geometry, config):
    hw, params, _ = GEOMETRIES[geometry]
    want = jex.extract_features_jit(jnp.asarray(_image(*hw)), params)
    got = _port(geometry, config)
    _assert_integer_columns_equal(got, want)
    d = np.abs(got.angle.numpy() - np.asarray(want.angle))
    assert np.minimum(d, 360 - d).max() < 1e-3
    bits = np.unpackbits(got.desc.numpy() ^ np.asarray(want.desc), axis=1).sum(axis=1)
    assert int((bits > 0).sum()) <= max(5, len(bits) // 100)
    assert bits.max() <= 4


def _np_angles(m10, m01):
    ang = np.degrees(np.arctan2(np.float64(m01), np.float64(m10))).astype(np.float32)
    return np.where(ang < 0, ang + np.float32(360.0), ang).astype(np.float32)


def _np_trig(angles):
    rad = np.float64(angles) * np.pi / 180.0
    return np.cos(rad).astype(np.float32), np.sin(rad).astype(np.float32)


def pin_trig(monkeypatch) -> None:
    """Both packages' extractors take atan2 and cos/sin in numpy from the
    same exact moments.  A reference program patched so must run eagerly:
    its jit is memoized by tests/conftest.py, which would not see the
    patch."""

    def jax_angles(img, xy):
        m10, m01 = jo.patch_moments(img, xy)
        return jnp.asarray(_np_angles(np.asarray(m10), np.asarray(m01)))

    def jax_brief(samp, xy, angles):
        cos, sin = _np_trig(np.asarray(angles))
        return jb.brief_descriptors(samp, xy, angles, trig=(jnp.asarray(cos), jnp.asarray(sin)))

    def port_angles(img, xy, weights=None, fused=False):
        m10, m01 = twg.window_moments(
            img, xy[:, 1] - HALF_PATCH_SIZE, xy[:, 0] - HALF_PATCH_SIZE, weights, fused=fused
        )
        return torch.from_numpy(_np_angles(m10.numpy(), m01.numpy()))

    def port_brief(samp, xy, angles, pattern=None, fused=False):
        trig = tuple(torch.from_numpy(t) for t in _np_trig(angles.numpy()))
        return tb.brief_descriptors(samp, xy, angles, trig=trig, pattern=pattern, fused=fused)

    monkeypatch.setattr(jex, "ic_angles", jax_angles)
    monkeypatch.setattr(jex, "brief_descriptors", jax_brief)
    monkeypatch.setattr(tex, "ic_angles", port_angles)
    monkeypatch.setattr(tex, "brief_descriptors", port_brief)


def pin_trig_jit(monkeypatch) -> None:
    """`pin_trig`, with the reference's atan2 and cos/sin as host callbacks,
    so that a reference program traced after it can run jitted (eagerly a
    stereo frame takes minutes on the CPU)."""
    pin_trig(monkeypatch)

    def jax_angles(img, xy):
        m10, m01 = jo.patch_moments(img, xy)
        out = jax.ShapeDtypeStruct(m10.shape, jnp.float32)
        return jax.pure_callback(
            lambda a, b: _np_angles(np.asarray(a), np.asarray(b)), out, m10, m01
        )

    def jax_brief(samp, xy, angles):
        out = jax.ShapeDtypeStruct(angles.shape, jnp.float32)
        trig = jax.pure_callback(lambda a: _np_trig(np.asarray(a)), (out, out), angles)
        return jb.brief_descriptors(samp, xy, angles, trig=trig)

    monkeypatch.setattr(jex, "ic_angles", jax_angles)
    monkeypatch.setattr(jex, "brief_descriptors", jax_brief)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_extract_features_exact_with_pinned_trig(geometry, config, monkeypatch):
    """Both extractors with atan2 and cos/sin taken in numpy from the same
    exact moments (`pin_trig`): every column equal.  The reference runs
    eagerly here."""
    pin_trig(monkeypatch)
    hw, params, _ = GEOMETRIES[geometry]
    want = jex.extract_features(jnp.asarray(_image(*hw)), params)
    got = _port(geometry, config)
    _assert_integer_columns_equal(got, want)
    np.testing.assert_array_equal(got.angle.numpy(), np.asarray(want.angle))
    np.testing.assert_array_equal(got.desc.numpy(), np.asarray(want.desc))


def test_cached_extractor_and_input_checks():
    params = TPyramidParams(n_features=500)
    fe = tex.feature_extractor(params, (240, 320), FusedKernels(), "cpu")
    assert fe is tex.feature_extractor(params, (240, 320), FusedKernels(), "cpu")
    assert fe is not tex.feature_extractor(params, (240, 320), FusedKernels(True, True, True), "cpu")
    with pytest.raises(ValueError, match="uint8"):
        fe(torch.zeros((240, 321), dtype=torch.uint8))
    packed = tex.pack_features(fe(torch.from_numpy(_image(240, 320))))
    assert tuple(packed.shape) == (500, tex.PACK_COLS)
    assert (packed[:, 6:8] == -1).all()  # no stereo columns for one camera
