"""The port's tools that measure the whole System, each on the CPU at a
small size: `bench_system` (the threaded System with the prefetch
pipeline), `bench_stages` (one stage), `trace_ops` (one frame),
`bench_matchers` (500 candidates: the device matcher returns the host
matcher's matches) and `profile_host` (a few frames).  Each refuses to
run without a card unless given --device=cpu."""

import importlib
import json

import numpy as np
import pytest
import torch

TOOLS = ("bench_system", "bench_stages", "trace_ops", "bench_matchers", "profile_host")


def test_bench_system_prints_the_references_lines(capsys):
    from orbslam3_tpu_torch.tools import bench_system

    assert bench_system.main(["12", "120", "160", "--device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu (--device=cpu)"
    per_frame, wall = (json.loads(line) for line in lines[1:3])
    assert per_frame["metric"] == "slam_system_ms_per_frame_pipelined"
    assert set(per_frame) == {"metric", "value", "unit", "mean", "p90", "fps", "frames",
                              "tracked", "ate_rmse_m", "note"}
    assert per_frame["frames"] == 12 and per_frame["tracked"] > 0
    assert np.isfinite(per_frame["ate_rmse_m"]) and per_frame["value"] > 0
    assert wall["metric"] == "slam_system_wall_s" and wall["value"] > 0


def test_bench_stages_times_a_stage(capsys):
    from orbslam3_tpu_torch.tools import bench_stages

    out = bench_stages.run({"select"}, device="cpu", h=120, w=160)
    assert list(out) == ["select"] and out["select"] > 0
    assert capsys.readouterr().out.startswith("select  : ")


def test_trace_ops_attributes_one_frame_to_the_ports_source(capsys):
    from orbslam3_tpu_torch.tools import trace_ops

    out = trace_ops.run(top_n=5, frames=1, device="cpu", h=120, w=160)
    text = capsys.readouterr().out
    assert "top 5 ops:" in text and "per source" in text
    assert sum(out["per_op"].values()) > 0
    sources = set(out["per_source"])
    # the stereo match's ops sit in its pair match's twin on the CPU
    assert {"ops/fast.py:nms3", "frontend/stereo_frame.py:stereo_pairs_plain"} <= sources, sources
    assert "graphed" not in out


def test_bench_matchers_device_matches_equal_the_hosts(capsys):
    from orbslam3_tpu_torch.slam import matchers
    from orbslam3_tpu_torch.tools import bench_matchers

    frame, mps = bench_matchers.make_scene(500)
    host = bench_matchers.matched(
        lambda: matchers.search_by_projection_local_map(frame, mps, th=2.0), frame)
    dev = bench_matchers.matched(lambda: matchers.search_by_projection_local_map_device(
        frame, mps, th=2.0, device=torch.device("cpu")), frame)
    assert (host >= 0).sum() > 100
    np.testing.assert_array_equal(dev, host)
    (line,) = bench_matchers.run([500], device="cpu")
    assert set(line) == {"metric", "host_ms", "device_ms", "faster"}
    assert line["metric"] == "search_by_projection_500_mps_ms"
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == line


def test_profile_host_profiles_a_few_frames(capsys):
    from orbslam3_tpu_torch.tools import profile_host

    assert profile_host.main(["--frames=5", "--device=cpu"]) == 0
    text = capsys.readouterr().out
    assert "5 frames in " in text and "track_stereo_features" in text


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_refuses_without_a_card(tool, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"orbslam3_tpu_torch.tools.{tool}")
    assert mod.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "runs on the card unless given --device=cpu" in out.err
