"""Port orientation and rBRIEF == JAX.

Integer moments are exact; atan2 and cos/sin may differ by ulps between
XLA and PyTorch (hazard C-h2), so angles are held to 1e-3 degrees and
unpinned descriptors to the bound of tests/test_brief.py: at most 1 % of
descriptors differ, by at most 4 bits each.  With trig pinned the
descriptors must match exactly.  The same holds where orientation and
rBRIEF are fed their windows gathered already, both in one
`gather_windows_many` call, as the extractor feeds them, and for the fused
rBRIEF (`brief_descriptors(fused=True)`), which on a CPU tensor runs its
plain twin `brief_descriptors_plain` and launches nothing."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.ops import brief as jb
from orbslam3_tpu.ops import orientation as jo
from orbslam3_tpu.oracle import orb_cpu as oc
from orbslam3_tpu_torch.ops import brief as tb
from orbslam3_tpu_torch.ops import orientation as to
from orbslam3_tpu_torch.ops.window_gather import gather_windows_many


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


def test_angles_and_descriptors_from_gathered_windows(scene):
    """The extractor's default path: the 31x31 orientation windows of the
    raw image and the 37x37 BRIEF windows of the sampling image gathered in
    one call, then ic_angles and brief_descriptors over them.  Angles equal
    the image path's bit for bit and JAX's within 1e-3 degrees; descriptors
    with pinned trig equal JAX's."""
    img, pts, _, samp = scene
    img_t, samp_t = torch.from_numpy(img), torch.from_numpy(samp)
    xy_i = torch.from_numpy(pts.astype(np.int32))
    xy_f = torch.from_numpy(pts)
    orient, brief = gather_windows_many([
        (img_t, *to.ic_window_starts(xy_i), to.IC_WINDOW, to.IC_WINDOW),
        (samp_t, *tb.brief_window_starts(xy_f), tb.BRIEF_WINDOW, tb.BRIEF_WINDOW),
    ])
    got = to.ic_angles(orient, xy_i)
    assert torch.equal(got, to.ic_angles(img_t, xy_i))
    want = np.asarray(jo.ic_angles(jnp.asarray(img), jnp.asarray(pts, jnp.int32)))
    d = np.abs(want - got.numpy())
    assert np.minimum(d, 360 - d).max() < 1e-3
    angles = np.random.default_rng(2).uniform(0, 360, len(pts)).astype(np.float32)
    rad = angles.astype(np.float64) * np.pi / 180.0
    cos, sin = np.cos(rad).astype(np.float32), np.sin(rad).astype(np.float32)
    want = np.asarray(
        jb.brief_descriptors(
            jnp.asarray(samp), jnp.asarray(pts), jnp.asarray(angles),
            trig=(jnp.asarray(cos), jnp.asarray(sin)),
        )
    )
    got = tb.brief_descriptors(
        brief, xy_f, torch.from_numpy(angles), trig=(torch.from_numpy(cos), torch.from_numpy(sin)),
    ).numpy()
    np.testing.assert_array_equal(got, want)


def _pinned(angles):
    rad = angles.astype(np.float64) * np.pi / 180.0
    return np.cos(rad).astype(np.float32), np.sin(rad).astype(np.float32)


def test_fused_descriptors_on_cpu_equal_jax_and_default(scene):
    """The fused rBRIEF on CPU tensors: equal to the JAX package with trig
    pinned and to the port's default composition either way, within the
    C-h2 bound of JAX unpinned; no kernel launch."""
    _, pts, _, samp = scene
    angles = np.random.default_rng(3).uniform(0, 360, len(pts)).astype(np.float32)
    cos, sin = _pinned(angles)
    samp_t, xy_t, ang_t = torch.from_numpy(samp), torch.from_numpy(pts), torch.from_numpy(angles)
    trig_t = (torch.from_numpy(cos), torch.from_numpy(sin))
    before = tb.brief_descriptors.launches
    got = tb.brief_descriptors(samp_t, xy_t, ang_t, trig=trig_t, fused=True)
    want = jb.brief_descriptors(jnp.asarray(samp), jnp.asarray(pts), jnp.asarray(angles),
                                trig=(jnp.asarray(cos), jnp.asarray(sin)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tb.brief_descriptors(samp_t, xy_t, ang_t, trig=trig_t))
    unpinned = tb.brief_descriptors(samp_t, xy_t, ang_t, fused=True)
    assert torch.equal(unpinned, tb.brief_descriptors(samp_t, xy_t, ang_t))
    want = np.asarray(jb.brief_descriptors(jnp.asarray(samp), jnp.asarray(pts), jnp.asarray(angles)))
    bits = np.unpackbits(want ^ unpinned.numpy(), axis=1).sum(axis=1)
    assert int((bits > 0).sum()) <= max(5, len(pts) // 100)
    assert bits.max(initial=0) <= 4
    assert tb.brief_descriptors.launches == before


def test_plain_twin_is_the_composition(scene):
    """brief_descriptors_plain against the composition it stands for,
    written out in numpy: the window start rint(xy) + BRIEF_PAD -
    PATCH_HALF clamped into the image, the rotated pattern rounded half to
    even (f32 products and sum), the picks, even < odd, LSB first; off-image
    keypoints and half-pixel positions included."""
    _, pts, _, samp = scene
    rng = np.random.default_rng(4)
    xy = np.concatenate([pts[:60], np.float32([[-30, 5], [400, 300], [10.5, 11.5], [12.5, 13.5]])])
    xy = xy.astype(np.float32)
    angles = rng.uniform(0, 360, len(xy)).astype(np.float32)
    cos, sin = _pinned(angles)
    got = tb.brief_descriptors_plain(
        torch.from_numpy(samp), torch.from_numpy(xy), torch.from_numpy(angles),
        trig=(torch.from_numpy(cos), torch.from_numpy(sin)),
    ).numpy()
    h, w = samp.shape
    px, py = tb.brief_pattern_np()
    r0 = np.clip(np.rint(xy[:, 1]).astype(np.int64) + tb.BRIEF_PAD - tb.PATCH_HALF, 0, h - 37)
    c0 = np.clip(np.rint(xy[:, 0]).astype(np.int64) + tb.BRIEF_PAD - tb.PATCH_HALF, 0, w - 37)
    a, b = cos[:, None], sin[:, None]
    dr = np.rint((px * b).astype(np.float32) + (py * a).astype(np.float32)).astype(np.int64)
    dc = np.rint((px * a).astype(np.float32) - (py * b).astype(np.float32)).astype(np.int64)
    samples = samp[r0[:, None] + dr + tb.PATCH_HALF, c0[:, None] + dc + tb.PATCH_HALF]
    want = np.packbits(samples[:, 0::2] < samples[:, 1::2], axis=1, bitorder="little")
    np.testing.assert_array_equal(got, want)


def test_fused_wrapper_checks_its_arguments(scene):
    _, pts, _, samp = scene
    samp_t, xy = torch.from_numpy(samp), torch.from_numpy(pts)
    ang = torch.zeros(len(pts))
    pattern = tb.brief_pattern("cpu")
    with pytest.raises(ValueError, match="pattern"):
        tb.brief_descriptors(samp_t, xy, ang, pattern=pattern[:, :256], fused=True)
    with pytest.raises(ValueError, match="pattern"):
        tb.brief_descriptors(samp_t, xy, ang, pattern=pattern.T.contiguous(), fused=True)
    with pytest.raises(ValueError, match="K"):
        tb.brief_descriptors(samp_t, xy, ang[:-1], pattern=pattern, fused=True)
    with pytest.raises(ValueError, match="K"):
        tb.brief_descriptors(samp_t, xy, ang, trig=(ang, ang[:-1]), pattern=pattern, fused=True)
    with pytest.raises(ValueError, match="xy"):
        tb.brief_descriptors(samp_t, xy[:, :1], ang, pattern=pattern, fused=True)
    with pytest.raises(ValueError, match="device"):
        tb.brief_descriptors(samp_t, xy.to("meta"), ang, pattern=pattern, fused=True)
    with pytest.raises(ValueError, match="device"):
        tb.brief_descriptors(samp_t, xy, ang, pattern=pattern.to("meta"), fused=True)
    windows = torch.zeros((len(pts), 37, 37), dtype=torch.uint8)
    with pytest.raises(ValueError, match="2-D"):
        tb.brief_descriptors(windows, xy, ang, pattern=pattern, fused=True)
    with pytest.raises(ValueError, match="at least 37x37"):
        tb.brief_descriptors(samp_t[:30], xy, ang, pattern=pattern, fused=True)
