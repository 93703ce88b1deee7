"""The port's System against the reference's in the two IMU
configurations no earlier test held: IMU_MONOCULAR and IMU_RGBD.

The same `utils.synth` sequences and the same `imu_samples_between`
samples go through both packages on the CPU, in the manner of
tests/test_mono_inertial.py (every second frame of an excited sweep, the
IMU over the whole gap) and tests/test_rgbd.py's
test_rgbd_inertial_auto_init.  Every frame's pose must agree within
1e-6 m (and 1e-6 in each rotation entry), the tracking states and map
statistics must be equal.  Fast tier: a few frames (monocular
initialisation and tracking with preintegrated IMU attached).  Slow tier:
the whole sequences, through visual-inertial initialisation in both
packages.
"""

import numpy as np
import pytest

from orbslam3_tpu.cameras.models import Pinhole as RefPinhole
from orbslam3_tpu.imu.preintegration import Calib as RefCalib
from orbslam3_tpu.oracle.orb_cpu import PyramidParams as RefParams
from orbslam3_tpu.slam.system import System as RefSystem
from orbslam3_tpu.utils.lie import SE3 as RefSE3
from orbslam3_tpu.utils.synth import imu_samples_between, rgbd_sequence, stereo_sequence
from orbslam3_tpu_torch import Pinhole, PyramidParams
from orbslam3_tpu_torch.imu.preintegration import Calib
from orbslam3_tpu_torch.slam.system import System
from orbslam3_tpu_torch.utils.lie import SE3

from test_mono_inertial import FPS, _excited_pose

FX = 350.0
H, W = 384, 512
NOISE = dict(noise_gyro=1e-4, noise_acc=1e-3, walk_gyro=1e-6, walk_acc=1e-5)


def _pair(sensor: str, mbf: float, max_frames: int):
    intr = [FX, FX, W / 2, H / 2]
    port = System(Pinhole(intr), mbf, PyramidParams(n_features=900), sensor=sensor,
                  sequential=True, max_frames=max_frames,
                  imu_calib=Calib(Tbc=SE3(), **NOISE), device="cpu")
    ref = RefSystem(RefPinhole(intr), mbf, RefParams(n_features=900), sensor=sensor,
                    sequential=True, max_frames=max_frames,
                    imu_calib=RefCalib(Tbc=RefSE3(), **NOISE))
    return port, ref


def mono_inertial(n_frames: int):
    """(port, reference, per-frame (port pose, reference pose, states))."""
    frames = stereo_sequence(n_frames, RefPinhole([FX, FX, W / 2, H / 2]), 0.12, H, W,
                             seed=1, pose_fn=_excited_pose)
    port, ref = _pair("mono-inertial", 0.0, 3)
    out, prev = [], None
    for k in range(0, n_frames, 2):
        imu = imu_samples_between(prev, k, FPS, pose_fn=_excited_pose) if prev is not None else None
        out.append((port.track_monocular(frames[k][0], k / FPS, imu=imu),
                    ref.track_monocular(frames[k][0], k / FPS, imu=imu),
                    port.get_tracking_state().name, ref.get_tracking_state().name))
        prev = k
    return port, ref, out


def rgbd_inertial(n_frames: int):
    frames = rgbd_sequence(n_frames, RefPinhole([FX, FX, W / 2, H / 2]), H, W, seed=1)
    port, ref = _pair(System.IMU_RGBD, FX * 0.08, 5)
    out = []
    for k, (img, depth, _) in enumerate(frames):
        imu = imu_samples_between(k - 1, k, FPS) if k > 0 else None
        out.append((port.track_rgbd(img, depth, k / FPS, imu=imu),
                    ref.track_rgbd(img, depth, k / FPS, imu=imu),
                    port.get_tracking_state().name, ref.get_tracking_state().name))
    return port, ref, out


def _assert_same_run(port, ref, out, min_poses: int):
    assert [(a is None, s) for a, _, s, _ in out] == [(b is None, s) for _, b, _, s in out]
    poses = [(a, b) for a, b, _, _ in out if a is not None]
    assert len(poses) >= min_poses
    for a, b in poses:
        np.testing.assert_allclose(a.t, b.t, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.R, b.R, rtol=0, atol=1e-6)
    assert port.map_stats() == ref.map_stats()
    # the IMU reached both trackers
    assert port.tracker.current.imu_preint is not None
    assert ref.tracker.current.imu_preint is not None
    np.testing.assert_allclose(port.tracker.current.imu_preint.dT,
                               ref.tracker.current.imu_preint.dT, rtol=0, atol=0)
    port.shutdown()
    ref.shutdown()


CONFIGS = {"mono_inertial": (mono_inertial, 12, 5), "rgbd_inertial": (rgbd_inertial, 5, 5)}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_inertial_configuration_matches_reference(config):
    run, n_frames, min_poses = CONFIGS[config]
    _assert_same_run(*run(n_frames), min_poses)


SLOW_CONFIGS = {"mono_inertial": (mono_inertial, 64), "rgbd_inertial": (rgbd_inertial, 40)}


@pytest.mark.slow
@pytest.mark.parametrize("config", sorted(SLOW_CONFIGS))
def test_inertial_configuration_through_vi_init_matches_reference(config):
    run, n_frames = SLOW_CONFIGS[config]
    port, ref, out = run(n_frames)
    assert port.atlas.get_current_map().imu_initialized
    assert ref.atlas.get_current_map().imu_initialized
    _assert_same_run(port, ref, out, len(out) - 2)
