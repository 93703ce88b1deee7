"""One cell driven end to end on the CPU at a tiny size, through the
harness's device hook (the command itself refuses without a card), and the
same run with the program broken underneath: each fault must make the
check read `correct` false.  The same run through a sensor defined here,
whose entry hands the System IMU samples, shows that a configuration of
another sensor needs no change to the harness or the loops."""

import importlib
import sys
import time
import types

import numpy as np
import pytest

from slambench import harness
from slambench import run as run_mod
from slambench.sensors import INTERFACE, stereo
from slambench.world.laps import sweep

CELL = "euroc_stereo.live"


def _tiny(bench) -> tuple:
    """The cell's configuration and mix at 320x240, 800 features, 5 Hz."""
    cell = harness.cell_of(bench, CELL)
    cfg = harness.config_of(bench, cell)
    s = 320 / cfg["Camera.width"]
    cfg.update({"Camera.width": 320, "Camera.height": 240, "ORBextractor.nFeatures": 800,
                "Camera.fps": 5})
    for k in ("fx", "fy", "cx", "cy", "bf"):
        cfg[f"Rectified.{k}"] *= s
    cfg["sequence"]["frames"] = 120
    cfg["vocabulary"]["train_frames"] = 2
    return cfg, dict(harness.mix_of(cell["traffic"]), rate_hz=5)


def _run(seconds: float = 2.0, sensor: str | None = None) -> dict:
    bench = harness.load_benchmark()
    cfg, mix = _tiny(bench)
    if sensor is not None:
        cfg["sensor"] = sensor
    out = harness.run_cell(bench, CELL, 2**31 + 99, seconds, False, time.perf_counter(),
                           device="cpu", cfg=cfg, mix=mix, log=lambda *_: None)
    line = run_mod.result_line(bench, harness.cell_of(bench, CELL), out, False,
                               {"platform": "cpu"})
    return line


def test_a_sound_run_is_correct():
    line = _run()
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == 10 and line["failed"] == 0
    assert line["metrics"]["frame_ms_mean"]["value"] > 0


def test_a_pose_left_unchanged_is_caught(monkeypatch):
    from orbslam3_tpu_torch.slam.tracking import Tracking

    real = Tracking.track_frame
    first = {}

    def frozen(self, frame):
        pose = real(self, frame)
        if pose is not None:
            first.setdefault("pose", pose)
        return first.get("pose")

    monkeypatch.setattr(Tracking, "track_frame", frozen)
    line = _run()
    assert line["correct"] is False
    assert line["checks"]["ate_m"]["value"] > line["checks"]["ate_m"]["limit"]


@pytest.mark.parametrize("fault", ["half_the_features_left_out", "a_descriptor_altered"])
def test_a_broken_front_end_is_caught(monkeypatch, fault):
    from orbslam3_tpu_torch.slam import system

    real = system.unpack_host_features

    def broken(arr):
        feats = real(arr)
        if fault == "half_the_features_left_out":
            return {k: v[::2] for k, v in feats.items()}
        feats["desc"] = feats["desc"].copy()
        feats["desc"][0, 0] ^= np.uint8(1)
        return feats

    monkeypatch.setattr(system, "unpack_host_features", broken)
    line = _run()
    assert line["correct"] is False
    assert line["checks"]["features_differ"]["value"] > 0


IMU_STEPS = 10  # IMU samples a frame: 200 Hz against EuRoC's 20


def _imu_samples(cfg: dict, n: int) -> list:
    """Frame k's (acc (S, 3), gyro (S, 3), dts (S,)): the body's specific
    force and rate at the middle of each of S steps from frame k - 1 to
    frame k, by central differences of the lap's poses at fractional frames
    (y points down)."""
    seq = cfg["sequence"]
    kind = importlib.import_module(f"slambench.world.laps.{seq['kind']}")
    ks = (np.arange(n * IMU_STEPS) + 0.5) / IMU_STEPS - 1.0
    dt = 1.0 / (cfg["Camera.fps"] * IMU_STEPS)
    h = 0.5 / IMU_STEPS
    (Ra, ca), (R, c), (Rb, cb) = (kind.poses(seq, ks + d) for d in (-h, 0.0, h))
    dR = np.einsum("nji,njk->nik", Ra, Rb)  # Ra^T Rb, a turn of 2h frames
    gyro = np.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0],
                     dR[:, 1, 0] - dR[:, 0, 1]], axis=1) / (2 * dt)
    acc_w = (ca - 2 * c + cb) / (dt / 2) ** 2 - np.array([0.0, 9.81, 0.0])
    acc = np.einsum("nji,nj->ni", R, acc_w)
    dts = np.full(IMU_STEPS, dt)
    return [(acc[i : i + IMU_STEPS], gyro[i : i + IMU_STEPS], dts)
            for i in range(0, n * IMU_STEPS, IMU_STEPS)]


def _imu_sensor(calls: list) -> types.ModuleType:
    """A stereo-inertial sensor: stereo's frames, System and reference, a
    lap that carries each frame's IMU samples, and an entry that hands them
    to `track_stereo` (recorded in `calls`)."""
    mod = types.ModuleType("slambench.sensors.stereo_imu_stub")
    for name in INTERFACE:
        setattr(mod, name, getattr(stereo, name))

    def render_lap(cfg, seed, device):
        lap = stereo.render_lap(cfg, seed, device)
        lap.imu = _imu_samples(cfg, len(lap))
        return lap

    def track(system, lap, k, timestamp):
        imu = lap.imu[k % len(lap)]
        calls.append((k, imu))
        left, right = lap.views(k)
        return system.track_stereo(left, right, timestamp, imu=imu)

    mod.render_lap, mod.track = render_lap, track
    return mod


def test_a_sensor_of_its_own_runs_through_the_harness(monkeypatch):
    from orbslam3_tpu_torch.slam.system import System

    calls, handed = [], []
    real = System.track_stereo

    def seen(self, img_l, img_r, timestamp, imu=None, **kw):
        handed.append(imu)
        return real(self, img_l, img_r, timestamp, imu=imu, **kw)

    monkeypatch.setattr(System, "track_stereo", seen)
    monkeypatch.setitem(sys.modules, "slambench.sensors.stereo_imu_stub",
                        _imu_sensor(calls))
    line = _run(sensor="stereo_imu_stub")
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["frame_ms_mean"]["value"] > 0
    assert line["attempted"] == 10 and len(calls) == len(handed) == 20 + 10
    for (k, imu), got in zip(calls, handed):
        assert got is imu and len(imu) == 3
        assert imu[0].shape == imu[1].shape == (IMU_STEPS, 3) and imu[2].shape == (IMU_STEPS,)
    # the samples are the lap's motion: a frame's rates turn frame k - 1 into frame k
    lap_R = sweep.poses(_tiny(harness.load_benchmark())[0]["sequence"], np.arange(-1, 30))[0]
    for k, (_, gyro, dts) in calls:
        turn = np.eye(3)
        for w, dt in zip(gyro, dts):
            turn = turn @ sweep._so3_exp(w[None] * dt)[0]
        want = lap_R[k].T @ lap_R[k + 1]  # R_wc(k - 1)^T R_wc(k)
        assert np.abs(turn - want).max() < 1e-3 * max(np.abs(want - np.eye(3)).max(), 1e-3)


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = harness.load_benchmark()
    out = harness.run_cell(bench, CELL, 7, 5.0, False, time.perf_counter())
    assert all(v <= lim for _, v, lim in out["checks"])
