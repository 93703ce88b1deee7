"""The port's RGB-D System on the CPU, under the fused configuration.

Held to the bar of tests/test_rgbd.py at its geometry (384x512, 900
features, a 25-frame synthetic sequence with 0.2 % depth noise): every
frame tracked, ATE RMSE under 1 cm.  Also the reference's depth-map-factor
case: uint16 TUM-style depth gives the depths of float metres."""

import numpy as np
import pytest

from orbslam3_tpu_torch.slam.tracking import TrackingState
from orbslam3_tpu_torch import FusedKernels, Pinhole, PyramidParams, ate_rmse, rgbd_sequence
from orbslam3_tpu_torch.slam.system import System

FX = 350.0
H, W = 384, 512
VIRTUAL_BF = FX * 0.08  # synthetic baseline * f for the u_right encoding
FUSED = FusedKernels(True, True, True)


@pytest.fixture(scope="module")
def run():
    camera = Pinhole([FX, FX, W / 2, H / 2])
    frames = rgbd_sequence(25, camera, H, W, seed=2, depth_noise=0.002)
    sysm = System(
        camera, VIRTUAL_BF, PyramidParams(n_features=900), sensor=System.RGBD,
        sequential=True, max_frames=8, device="cpu", fused=FUSED,
    )
    est, gt, states = [], [], []
    for k, (img, depth, tcw_gt) in enumerate(frames):
        pose = sysm.track_rgbd(img, depth, timestamp=k / 20.0)
        states.append(sysm.get_tracking_state())
        if pose is not None:
            est.append(pose)
            gt.append(tcw_gt)
    sysm.shutdown()
    return est, gt, states


def test_rgbd_tracks_every_frame(run):
    est, _, states = run
    assert len(est) == 25
    assert all(s == TrackingState.OK for s in states)


def test_rgbd_ate_sub_centimeter(run):
    est, gt, _ = run
    rmse = ate_rmse(est, gt)
    assert rmse < 0.01, f"ATE RMSE {rmse * 100:.2f} cm"


def test_depth_map_factor_scaling():
    camera = Pinhole([FX, FX, W / 2, H / 2])
    img, depth_m, _ = rgbd_sequence(1, camera, H, W, seed=2)[0]
    depth_u16 = np.clip(depth_m * 5000.0, 0, 65535).astype(np.uint16)
    systems = [
        System(camera, VIRTUAL_BF, PyramidParams(n_features=500), sensor=System.RGBD,
               device="cpu", fused=FUSED)
        for _ in range(2)
    ]
    systems[1].depth_map_factor = 5000.0
    systems[0].track_rgbd(img, depth_m, 0.0)
    systems[1].track_rgbd(img, depth_u16, 0.0)
    f1, f2 = (s.tracker.current for s in systems)
    assert f1.n == f2.n
    good = (f1.depth > 0) & (f2.depth > 0)
    assert good.sum() > 200
    np.testing.assert_allclose(f1.depth[good], f2.depth[good], atol=2e-4)
