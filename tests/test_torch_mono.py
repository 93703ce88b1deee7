"""The port's monocular System on the CPU, under the fused configuration.

Held to the bar of tests/test_mono.py at its geometry (384x512, 900
features, so the 5x init extractor takes 4500; every second frame of the
synthetic sequence): tracking OK at the end, at least 6 poses,
Sim3-aligned ATE under 5 cm, more than 80 map points.  The sequence is cut
from the reference test's 32 frames to 20 to keep this file near a minute
on the CPU; chip_smoke.py holds the port to the same bar over 30
frames at 752x480 on the card."""

import pytest

from orbslam3_tpu_torch.slam.tracking import TrackingState
from orbslam3_tpu_torch import FusedKernels, Pinhole, PyramidParams, ate_rmse, stereo_sequence
from orbslam3_tpu_torch.ops import extractor as tex
from orbslam3_tpu_torch.slam.system import System

FX = 350.0
H, W = 384, 512


@pytest.fixture(scope="module")
def run():
    camera = Pinhole([FX, FX, W / 2, H / 2])
    frames = stereo_sequence(20, camera, 0.12, H, W, seed=1)
    sysm = System(
        camera, mbf=0.0, orb_params=PyramidParams(n_features=900), sensor=System.MONOCULAR,
        sequential=True, max_frames=8, device="cpu", fused=FusedKernels(True, True, True),
    )
    est, gt, n_feats = [], [], []
    for k, (img, _, tcw_gt) in enumerate(frames):
        if k % 2:  # skip frames to give the two-view init parallax
            continue
        pose = sysm.track_monocular(img, timestamp=k / 20.0)
        n_feats.append(sysm.tracker.current.n)
        if pose is not None:
            est.append(pose)
            gt.append(tcw_gt)
    sysm.shutdown()
    return sysm, est, gt, n_feats


def test_mono_initialises_and_tracks(run):
    sysm, est, _, _ = run
    assert sysm.get_tracking_state() == TrackingState.OK
    assert len(est) >= 6, len(est)


def test_mono_ate_sim3_under_5cm(run):
    _, est, gt, _ = run
    rmse = ate_rmse(est, gt, with_scale=True)
    assert rmse < 0.05, f"mono ATE {rmse * 100:.2f} cm"


def test_mono_map_grows(run):
    sysm, *_ = run
    assert sysm.map_stats()["n_map_points"] > 80


def test_mono_init_extractor_takes_5x_features(run):
    """The init extractor (4500 slots) runs before and for max_frames after
    initialisation; both extractors come from the cache."""
    _, _, _, n_feats = run
    assert max(n_feats) > 900 >= n_feats[-1]
    fused = FusedKernels(True, True, True)
    for n in (900, 4500):
        fe = tex.feature_extractor(PyramidParams(n_features=n), (H, W), fused, "cpu")
        assert fe.slot_octave.shape[0] == n
