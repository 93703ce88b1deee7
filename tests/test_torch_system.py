"""The port's System tracks a synthetic stereo sequence on the CPU.

Held to the bar of tests/test_slam_e2e.py: every frame tracked, ATE RMSE
under 1 cm.  A subprocess run of the stereo, mono and RGB-D entry points,
with `jax` and `orbslam3_tpu` refused on `sys.meta_path`, shows that the
port imports neither (this process cannot: tests/conftest.py imports
them)."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from orbslam3_tpu_torch.slam.tracking import TrackingState
from orbslam3_tpu_torch import Pinhole, PyramidParams, ate_rmse, stereo_sequence
from orbslam3_tpu_torch.slam.system import System

FX = 350.0
H, W = 384, 512
BASELINE = 0.12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    camera = Pinhole([FX, FX, W / 2, H / 2])
    frames = stereo_sequence(10, camera, BASELINE, H, W, seed=1)
    sysm = System(
        camera, FX * BASELINE, PyramidParams(n_features=900), sequential=True,
        max_frames=8, device="cpu",
    )
    est, gt, states = [], [], []
    for k, (img_l, img_r, tcw_gt) in enumerate(frames):
        pose = sysm.track_stereo(img_l, img_r, timestamp=k / 20.0)
        states.append(sysm.get_tracking_state())
        if pose is not None:
            est.append(pose)
            gt.append(tcw_gt)
    path = tmp_path_factory.mktemp("traj") / "traj.txt"
    sysm.save_trajectory_tum(str(path))
    sysm.shutdown()
    return est, gt, states, path


def test_tracks_every_frame(run):
    est, _, states, _ = run
    assert len(est) == 10
    assert all(s == TrackingState.OK for s in states)


def test_ate_sub_centimeter(run):
    est, gt, _, _ = run
    assert ate_rmse(est, gt) < 0.01


def test_trajectory_saved(run):
    *_, path = run
    assert len(path.read_text().strip().splitlines()) == 10


def test_device_is_explicit():
    import torch

    camera = Pinhole([FX, FX, W / 2, H / 2])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            System(camera, FX * BASELINE)
    # the entry points that once raised NotImplementedError run on the CPU
    # when asked: batched prefetch, and the fisheye path's track_stereo and
    # prefetch_stereo (the pinhole program, as in the reference)
    sysm = System(camera, FX * BASELINE, device="cpu")
    with pytest.raises(ValueError):
        sysm.prefetch_stereo_batch([])
    frames = stereo_sequence(2, camera, BASELINE, H, W, seed=1)
    handles = sysm.prefetch_stereo_batch([(l, r) for l, r, _ in frames])
    assert [h[3] for h in handles] == [(H, W)] * 2
    assert sysm.track_stereo_prefetched(handles[0], 0.0) is not None
    from orbslam3_tpu_torch.cameras.models import KannalaBrandt8
    from orbslam3_tpu_torch.utils.lie import SE3

    kb8 = KannalaBrandt8([FX, FX, W / 2, H / 2, 0.0, 0.0, 0.0, 0.0])
    fisheye = System(kb8, FX * BASELINE, camera2=kb8, Tlr=SE3(np.eye(3), [BASELINE, 0.0, 0.0]),
                     lapping1=(0.0, W), lapping2=(0.0, W), device="cpu")
    l, r, _ = frames[0]
    assert fisheye.track_stereo(l, r, 0.0) is not None
    assert fisheye.tracker.current.n_left < fisheye.tracker.current.n
    host, done, _, _ = fisheye.prefetch_stereo(l, r)
    np.testing.assert_array_equal(host, handles[0][0].__array__())


def test_port_never_imports_jax():
    script = textwrap.dedent(
        """
        import sys


        class _Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "orbslam3_tpu"):
                    raise ImportError("the port must not import " + name)
                return None


        sys.meta_path.insert(0, _Refuse())
        from orbslam3_tpu_torch import (
            FusedKernels, Pinhole, PyramidParams, rgbd_sequence, stereo_sequence,
        )
        from orbslam3_tpu_torch.slam.system import System

        cam = Pinhole([350.0, 350.0, 160.0, 120.0])
        params = PyramidParams(n_features=500)
        sysm = System(cam, 42.0, params, device="cpu")
        frames = stereo_sequence(2, cam, 0.12, 240, 320, seed=1)
        for k, (l, r, _) in enumerate(frames):
            sysm.track_stereo(l, r, timestamp=k / 20.0)
        handle = sysm.prefetch_stereo(frames[0][0], frames[0][1])
        sysm.track_stereo_prefetched(handle, timestamp=0.1)
        sysm.shutdown()
        fused = FusedKernels(True, True, True)
        mono = System(cam, 0.0, params, sensor=System.MONOCULAR, device="cpu", fused=fused)
        for k, (l, _, _) in enumerate(frames):
            mono.track_monocular(l, timestamp=k / 20.0)
        mono.shutdown()
        rgbd = System(cam, 28.0, params, sensor=System.RGBD, device="cpu", fused=fused)
        for k, (img, depth, _) in enumerate(rgbd_sequence(2, cam, 240, 320, seed=2)):
            rgbd.track_rgbd(img, depth, timestamp=k / 20.0)
        rgbd.shutdown()
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "orbslam3_tpu"))
        assert not leaked, leaked
        print("NO_JAX_OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
