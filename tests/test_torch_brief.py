"""Port orientation and rBRIEF == JAX.

Integer moments are exact; atan2 and cos/sin may differ by ulps between
XLA and PyTorch (hazard C-h2), so angles are held to 1e-3 degrees and
unpinned descriptors to the bound of tests/test_brief.py: at most 1 % of
descriptors differ, by at most 4 bits each.  With trig pinned the
descriptors must match exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.ops import brief as jb
from orbslam3_tpu.ops import orientation as jo
from orbslam3_tpu.oracle import orb_cpu as oc
from orbslam3_tpu_torch.ops import brief as tb
from orbslam3_tpu_torch.ops import orientation as to


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(21)
    h, w = 240, 320
    yy, xx = np.mgrid[0:h, 0:w]
    img = (120 + 60 * np.sin(xx / 17.0) * np.cos(yy / 11.0) + rng.normal(0, 18, (h, w)))
    img = img.clip(0, 255).astype(np.uint8)
    score = oc.nms3(oc.fast_score_map(img, 20))
    score[:19], score[h - 19 :], score[:, :19], score[:, w - 19 :] = 0, 0, 0, 0
    ys, xs = np.nonzero(score)
    order = np.argsort(-score[ys, xs], kind="stable")[:400]
    pts = np.stack([xs[order], ys[order]], 1).astype(np.float32)
    blurred = oc.gaussian_blur7_u8(img)
    samp = np.array(jb.brief_sampling_image(jnp.asarray(img), jnp.asarray(blurred)))
    return img, pts, blurred, samp


def test_sampling_image_exact(scene):
    img, _, blurred, samp = scene
    got = tb.brief_sampling_image(torch.from_numpy(img), torch.from_numpy(blurred))
    np.testing.assert_array_equal(got.numpy(), samp)


def test_ic_angles_within_1e3_degrees(scene):
    img, pts, _, _ = scene
    want = np.asarray(jo.ic_angles(jnp.asarray(img), jnp.asarray(pts, jnp.int32)))
    got = to.ic_angles(torch.from_numpy(img), torch.from_numpy(pts.astype(np.int32))).numpy()
    d = np.abs(want - got)
    d = np.minimum(d, 360 - d)
    assert d.max() < 1e-3
    assert ((got >= 0) & (got < 360)).all()


def test_descriptors_exact_with_pinned_trig(scene):
    _, pts, _, samp = scene
    rng = np.random.default_rng(0)
    angles = rng.uniform(0, 360, len(pts)).astype(np.float32)
    rad = angles.astype(np.float64) * np.pi / 180.0
    cos, sin = np.cos(rad).astype(np.float32), np.sin(rad).astype(np.float32)
    want = np.asarray(
        jb.brief_descriptors(
            jnp.asarray(samp), jnp.asarray(pts), jnp.asarray(angles),
            trig=(jnp.asarray(cos), jnp.asarray(sin)),
        )
    )
    got = tb.brief_descriptors(
        torch.from_numpy(samp), torch.from_numpy(pts), torch.from_numpy(angles),
        trig=(torch.from_numpy(cos), torch.from_numpy(sin)),
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_descriptors_unpinned_within_trig_bound(scene):
    _, pts, _, samp = scene
    angles = np.random.default_rng(1).uniform(0, 360, len(pts)).astype(np.float32)
    want = np.asarray(
        jb.brief_descriptors(jnp.asarray(samp), jnp.asarray(pts), jnp.asarray(angles))
    )
    got = tb.brief_descriptors(
        torch.from_numpy(samp), torch.from_numpy(pts), torch.from_numpy(angles)
    ).numpy()
    bits = np.unpackbits(want ^ got, axis=1).sum(axis=1)
    assert int((bits > 0).sum()) <= max(5, len(pts) // 100)
    assert bits.max(initial=0) <= 4
