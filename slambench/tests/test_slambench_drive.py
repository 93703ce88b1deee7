"""One cell driven end to end on the CPU at a tiny size, through the
harness's device hook (the command itself refuses without a card), and the
same run with the program broken underneath: each fault must make the
check read `correct` false."""

import time

import numpy as np
import pytest

from slambench import harness
from slambench import run as run_mod

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


def _run(seconds: float = 2.0) -> dict:
    bench = harness.load_benchmark()
    cfg, mix = _tiny(bench)
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


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = harness.load_benchmark()
    out = harness.run_cell(bench, CELL, 7, 5.0, False, time.perf_counter())
    assert all(v <= lim for _, v, lim in out["checks"])
