"""No result of the port depends on cv2: its own counterparts of the three
cv2 calls the reference makes on the tracking path, held to cv2 here.

- `frontend.rectify.remap_bilinear` (torch, on the image's device) equals
  `cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0)` bit for bit, on random
  images and maps (taps outside the image, half-pixel and non-finite
  coordinates included) and on EuRoC's rectification maps;
  `StereoRectifier.rectify` equals the JAX package's (which calls cv2) on
  tests/test_rectified_slam.py's rig.
- `optim.two_view.decompose_homography` equals
  `cv2.decomposeHomographyMat`: the same solutions in the same order,
  within 1e-9; `TwoViewReconstruction` takes that path on a planar scene
  (H/(H+F) > 0.40) and equals the reference's.
- `System._resize` equals `cv2.resize(INTER_LINEAR)` bit for bit.
"""

import cv2
import numpy as np
import pytest
import torch

from orbslam3_tpu.frontend.rectify import StereoRectifier as RefRectifier
from orbslam3_tpu.optim import two_view as ref_two_view
from orbslam3_tpu.utils.synth import stereo_sequence
from orbslam3_tpu_torch.cameras.models import Pinhole
from orbslam3_tpu_torch.frontend.rectify import StereoRectifier, remap_bilinear
from orbslam3_tpu_torch.optim import two_view
from orbslam3_tpu_torch.slam.system import System
from orbslam3_tpu_torch.utils.lie import SE3, so3_exp

from test_rectified_slam import BASELINE, CAM_L, CAM_R, H, T_RL, W
from test_rectify import D1, D2, K1, K2, R_12, SIZE, T_12


def _remap(img, mx, my):
    return remap_bilinear(torch.from_numpy(img), torch.from_numpy(mx), torch.from_numpy(my)).numpy()


@pytest.mark.parametrize("seed", range(6))
def test_remap_bilinear_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    h, w, ho, wo = (int(v) for v in rng.integers(2, 160, 4))
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    # coordinates from 3 px outside the image to 3 px past its far edge,
    # maps of another size than the image
    mx = rng.uniform(-3, w + 3, (ho, wo)).astype(np.float32)
    my = rng.uniform(-3, h + 3, (ho, wo)).astype(np.float32)
    mx[::3] = (np.round(mx[::3] * 64) / 64).astype(np.float32)  # 1/64 px steps
    my[1::4] = (np.round(my[1::4] * 2) / 2).astype(np.float32)  # half pixels
    mx[0, :3] = [np.nan, np.inf, -np.inf]
    my[-1, :2] = [np.nan, 1e9]
    np.testing.assert_array_equal(_remap(img, mx, my), cv2.remap(img, mx, my, cv2.INTER_LINEAR))


def test_remap_bilinear_batch_equals_one_by_one():
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (3, 37, 53), dtype=np.uint8)
    mx = rng.uniform(-3, 56, (3, 41, 29)).astype(np.float32)
    my = rng.uniform(-3, 40, (3, 41, 29)).astype(np.float32)
    got = _remap(imgs, mx, my)
    for i in range(3):
        np.testing.assert_array_equal(got[i], cv2.remap(imgs[i], mx[i], my[i], cv2.INTER_LINEAR))


def test_remap_bilinear_on_euroc_rectification_maps(test_image):
    """752x480 with EuRoC MH01's calibration: every pixel equal."""
    from orbslam3_tpu_torch.frontend.rectify import init_undistort_rectify_map, stereo_rectify

    r1, r2, p1, p2 = stereo_rectify(K1, D1, K2, D2, SIZE, R_12, T_12)
    for k, d, r, p in ((K1, D1, r1, p1), (K2, D2, r2, p2)):
        mx, my = init_undistort_rectify_map(k, d, r, p, SIZE)
        np.testing.assert_array_equal(
            _remap(test_image, mx, my), cv2.remap(test_image, mx, my, cv2.INTER_LINEAR)
        )


def test_stereo_rectifier_matches_reference():
    """The port's rectifier (torch on the CPU) against the JAX package's
    (cv2.remap) on tests/test_rectified_slam.py's distorted rig."""
    frames = stereo_sequence(2, CAM_L, BASELINE, H, W, seed=3, camera_r=CAM_R, T_rl=T_RL)
    ref = RefRectifier(CAM_L, CAM_R, T_RL.inverse(), (W, H))
    port = StereoRectifier(
        Pinhole([CAM_L.fx, CAM_L.fy, CAM_L.cx, CAM_L.cy], CAM_L.dist),
        Pinhole([CAM_R.fx, CAM_R.fy, CAM_R.cx, CAM_R.cy], CAM_R.dist),
        SE3(T_RL.R, T_RL.t).inverse(), (W, H),
    )
    for name in ("map1x", "map1y", "map2x", "map2y", "R1", "P1", "P2"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    for il, ir, _ in frames:
        got = port.rectify(il, ir, "cpu")
        want = ref.rectify(il, ir)
        assert all(g.dtype == torch.uint8 and g.device.type == "cpu" for g in got)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w_)


def _homographies():
    rng = np.random.default_rng(7)
    k = np.array([[350.0, 0, 160], [0, 352.0, 118], [0, 0, 1]])
    out = []
    for i in range(40):
        h = np.eye(3) + rng.normal(0, 0.3 if i % 2 else 0.05, (3, 3))
        out.append((k @ h @ np.linalg.inv(k) * rng.uniform(0.5, 2.0), k))
    # the homography of a plane seen from two poses, the case init meets
    r = so3_exp(np.array([0.02, -0.1, 0.03]))
    t, n, d = np.array([0.3, 0.02, 0.05]), np.array([0.1, -0.2, 1.0]), 4.0
    out.append((k @ (r + np.outer(t, n / np.linalg.norm(n)) / d) @ np.linalg.inv(k), k))
    return out


def test_decompose_homography_matches_cv2():
    for h, k in _homographies():
        n, rs, ts, ns = cv2.decomposeHomographyMat(h, k)
        got = two_view.decompose_homography(h, k)
        assert len(got) == n == 4
        for (r, t, nn), rw, tw, nw in zip(got, rs, ts, ns):
            np.testing.assert_allclose(r, rw, rtol=0, atol=1e-9)
            np.testing.assert_allclose(t, tw.ravel(), rtol=0, atol=1e-9)
            np.testing.assert_allclose(nn, nw.ravel(), rtol=0, atol=1e-9)


def test_decompose_homography_of_a_rotation():
    k = np.array([[350.0, 0, 160], [0, 350.0, 120], [0, 0, 1]])
    h = k @ so3_exp(np.array([0.1, 0.2, 0.3])) @ np.linalg.inv(k)
    n, rs, ts, _ = cv2.decomposeHomographyMat(h, k)
    got = two_view.decompose_homography(h, k)
    assert len(got) == n == 1
    np.testing.assert_allclose(got[0][0], rs[0], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got[0][1], ts[0].ravel())


def _planar_views(tv_mod, lie_mod, cam):
    rng = np.random.default_rng(11)
    uv = rng.uniform([-1.5, -1.0], [1.5, 1.0], (220, 2))
    pw = np.column_stack([uv, 4.0 + 0.3 * uv[:, 0] - 0.2 * uv[:, 1]])  # a tilted plane
    t21 = lie_mod.SE3(lie_mod.so3_exp([0.01, -0.08, 0.02]), np.array([0.35, 0.03, 0.04]))
    p1 = cam.project(pw) + rng.normal(0, 0.3, (len(pw), 2))
    p2 = cam.project(pw @ t21.R.T + t21.t) + rng.normal(0, 0.3, (len(pw), 2))
    return tv_mod.TwoViewReconstruction(cam, seed=2).reconstruct(p1, p2)


def test_two_view_planar_scene_matches_reference(monkeypatch):
    """A planar scene (H/(H+F) > 0.40): the port takes its own
    decomposition where the reference takes cv2's; the same
    reconstruction within 1e-9."""
    from orbslam3_tpu.cameras.models import Pinhole as RefPinhole
    from orbslam3_tpu.utils import lie as ref_lie
    from orbslam3_tpu_torch.utils import lie

    calls = []
    real = two_view.decompose_homography
    monkeypatch.setattr(two_view, "decompose_homography",
                        lambda h, k: calls.append(1) or real(h, k))
    intr = [350.0, 350.0, 256.0, 192.0]
    got = _planar_views(two_view, lie, Pinhole(intr))
    want = _planar_views(ref_two_view, ref_lie, RefPinhole(intr))
    assert calls, "the homography path was not taken"
    assert got[0] and want[0]
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want) > 2
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=0, atol=1e-9)


def _leaves(x) -> list:
    """The float64 arrays of a reconstruction (an SE3 as R and t)."""
    if x is None or isinstance(x, (bool, int, float, np.ndarray, np.generic)):
        return [np.asarray(x, np.float64)]
    if isinstance(x, (tuple, list)):
        return [a for item in x for a in _leaves(item)]
    return [np.asarray(x.R, np.float64), np.asarray(x.t, np.float64)]


# downscaling, as Camera.newWidth / newHeight usually ask, and upscaling
@pytest.mark.parametrize("size", [(376, 240), (640, 400), (333, 211), (1024, 768), (800, 600)])
def test_resize_matches_cv2(test_image, size):
    np.testing.assert_array_equal(
        System._resize(test_image, size), cv2.resize(test_image, size, interpolation=cv2.INTER_LINEAR)
    )
