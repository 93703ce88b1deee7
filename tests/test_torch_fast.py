"""Port FAST (B1 twin, retry, NMS) == JAX FAST, bit-exact.

The twin is held against both the JAX XLA form (what the JAX package runs
off the TPU) and the Pallas kernel in interpret mode.  The CUDA kernel
itself is held against the twin on the card by chip_smoke.py; the `cuda`
test below runs only where a card is present.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.ops import fast as jf
from orbslam3_tpu_torch.ops import fast as tf

ODD_SIZES = ((65, 130), (96, 746), (57, 57))


def _img(h, w, seed=5):
    return np.random.default_rng(seed).integers(0, 255, (h, w), np.uint8)


def _seam_mask(h, w):
    mask = np.zeros((h, w), bool)
    mask[3 : h - 3, 3 : w - 3] = True
    mask[:, w // 3 : w // 3 + 5] = False  # fake level seam
    mask[h // 2 : h // 2 + 7, :] = False
    return mask


@pytest.mark.parametrize("hw", ODD_SIZES)
def test_twin_matches_xla_form(hw):
    img = _img(*hw)
    want = np.asarray(jf.raw_score_map(jnp.asarray(img)))
    got = tf.raw_score_map_plain(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", ODD_SIZES)
@pytest.mark.parametrize("masked", [False, True])
def test_twin_matches_pallas_interpret(hw, masked):
    img = _img(*hw, seed=hw[0])
    mask = _seam_mask(*hw) if masked else None
    want = np.asarray(jf._raw_score_pallas(jnp.asarray(img), interpret=True, mask_np=mask))
    got = tf.raw_score_map_plain(
        torch.from_numpy(img), None if mask is None else torch.from_numpy(mask)
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_uses_twin_on_cpu_and_checks_mask():
    img = torch.from_numpy(_img(40, 50))
    before = tf.raw_score_map.launches
    want = tf.raw_score_map_plain(img).numpy()
    np.testing.assert_array_equal(tf.raw_score_map(img).numpy(), want)
    assert tf.raw_score_map.launches == before  # no kernel launch for a CPU tensor
    bad = torch.zeros((40, 50), dtype=torch.bool)
    bad[1, 10] = True
    with pytest.raises(ValueError, match="contract"):
        tf.raw_score_map(img, bad)


@pytest.mark.parametrize("edge", ["top", "bottom", "left", "right"])
def test_mask_contract_checked_in_numpy(edge):
    """Every True pixel must be >= 3 px inside; a layout's own mask passes."""
    _, _, mask = tf.detection_layout([(40, 50), (20, 30)])
    tf.check_mask_np(mask, mask.shape)
    bad = mask.copy()
    h, w = bad.shape
    y, x = {"top": (2, 10), "bottom": (h - 3, 10), "left": (10, 2), "right": (10, w - 3)}[edge]
    bad[y, x] = True
    with pytest.raises(ValueError, match="contract"):
        tf.check_mask_np(bad, bad.shape)


def test_detect_two_threshold_multi_bit_exact():
    """Both cameras' crops of a 240x320 pyramid through one composite."""
    from orbslam3_tpu.oracle.orb_cpu import PyramidParams
    from orbslam3_tpu.ops import extractor as jx
    from orbslam3_tpu.ops.pyramid import build_pyramid

    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:240, 0:320]
    crops = []
    for cam in range(2):
        img = (120 + 60 * np.sin((xx + 9 * cam) / 9.0) * np.cos(yy / 13.0)
               + rng.normal(0, 20, (240, 320))).clip(0, 255).astype(np.uint8)
        pyr = build_pyramid(jnp.asarray(img), PyramidParams())
        crops += jx.detection_crops(pyr, PyramidParams())[1]
    want = jf.detect_two_threshold_multi(crops, 20, 7)
    got = tf.detect_two_threshold_multi([torch.from_numpy(np.array(c)) for c in crops], 20, 7)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nms3_matches_jax():
    score = np.random.default_rng(2).integers(0, 6, (37, 53)).astype(np.int32)
    np.testing.assert_array_equal(
        tf.nms3(torch.from_numpy(score)).numpy(), np.asarray(jf.nms3(jnp.asarray(score)))
    )


@pytest.mark.cuda
def test_kernel_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    for h, w in ODD_SIZES:
        img = torch.from_numpy(_img(h, w)).cuda()
        got = tf.raw_score_map(img)
        torch.cuda.synchronize()
        assert torch.equal(got, tf.raw_score_map_plain(img))
