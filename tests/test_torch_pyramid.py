"""Port pyramid == JAX pyramid, bit-exact (integer arithmetic both sides)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu.oracle.orb_cpu import PyramidParams
from orbslam3_tpu.ops import pyramid as jp
from orbslam3_tpu_torch import PyramidParams as TPyramidParams
from orbslam3_tpu_torch.ops import pyramid as tp


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 128 + 70 * np.sin(xx / 11.0) * np.cos(yy / 7.0) + rng.normal(0, 25, (h, w))
    return img.clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("hw", [(240, 320), (97, 131)])
def test_build_pyramid_bit_exact(hw):
    img = _image(*hw, seed=1)
    params = PyramidParams()
    want = [np.asarray(l) for l in jp.build_pyramid(jnp.asarray(img), params)]
    got = [l.numpy() for l in tp.build_pyramid(torch.from_numpy(img), TPyramidParams())]
    assert [g.shape for g in got] == [w.shape for w in want]
    for level, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"level {level}")


@pytest.mark.parametrize("dst", [(57, 91), (200, 301), (13, 17)])
def test_resize_linear_bit_exact(dst):
    img = _image(120, 160, seed=2)
    want = np.asarray(jp.resize_linear_u8(jnp.asarray(img), *dst))
    got = tp.resize_linear_u8(torch.from_numpy(img), *dst).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reflect", [True, False])
def test_gaussian_blur_bit_exact(reflect):
    img = _image(240, 320, seed=3)
    want = np.asarray(jp.gaussian_blur7_u8(jnp.asarray(img), reflect))
    got = tp.gaussian_blur7_u8(torch.from_numpy(img), reflect).numpy()
    np.testing.assert_array_equal(got, want)
