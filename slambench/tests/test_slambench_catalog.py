"""BENCHMARK.json against the contract's shape, and the harness finding each
cell's configuration, sensor, traffic mix and per-layer readers by name."""

import json
import re

import pytest

from slambench import harness
from slambench import run as run_mod
from slambench.sensors import INTERFACE

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_benchmark_has_the_contract_keys(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert bench["paths"] == ["slambench"]
    assert bench["command"][:3] == ["python3", "-m", "slambench.run"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"] + bench["workloads"]
             + bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_finds_its_files(bench):
    for cell in bench["workloads"]:
        cfg = harness.config_of(bench, cell)
        assert cfg["name"] == cell["config"] and cell["chips"] == 1
        mix = harness.mix_of(cell["traffic"])
        loop = harness.loop_of(mix)
        assert callable(loop.warm_up) and callable(loop.run)
        e2e, layer = harness.metrics_of(bench, cell)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
        for m in layer:
            assert callable(harness.reader_of(m["name"]))
    for entry in bench["configs"]:
        assert any(c["config"] == entry["name"] for c in bench["workloads"])
        cfg = json.load(open(harness.ROOT / entry["file"]))
        assert cfg["reduced"] == entry["reduced"] and cfg["source"] == entry["source"]


def test_every_config_finds_its_sensor():
    for path in sorted((harness.HERE / "configs").glob("*.json")):
        cfg = json.load(open(path))
        sensor = harness.sensor_of(cfg)
        assert sensor.__name__ == f"slambench.sensors.{cfg['sensor']}"
        for name in INTERFACE:
            assert hasattr(sensor, name), (path.name, name)
        assert all(isinstance(f, str) for f in sensor.FIELDS) and sensor.FIELDS
        assert all(callable(getattr(sensor, n)) for n in INTERFACE if n != "FIELDS")


def test_an_unknown_sensor_names_its_missing_file():
    with pytest.raises(ModuleNotFoundError, match=r"slambench/sensors/sonar\.py"):
        harness.sensor_of({"name": "x", "sensor": "sonar"})


def test_readers_return_nothing_without_data(bench):
    run = {"records": {}, "host": {}, "trace": None, "least_s": 1e-5}
    for m in bench["per_layer"]:
        assert harness.reader_of(m["name"])(run) is None


def _out(traced: bool) -> dict:
    out = {"checks": [("features_differ", 0, 0), ("ate_m", 0.002, 0.01),
                      ("untracked_share", 0.0, 0.0)],
           "attempted": 10, "failed": 0,
           "e2e": {"setup_s": (12.5, "s"), "frame_ms_mean": (40.0, "ms")}}
    if traced:
        out["run"] = {"records": {"2_Track": [9.0]}, "host": {"frame_ms": [20.0]},
                      "trace": None, "least_s": 1e-5}
    return out


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_holds_the_contract_keys(bench, traced):
    cell = bench["workloads"][0]
    device = {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1}
    line = run_mod.result_line(bench, cell, _out(traced), traced, device)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    e2e, layer = harness.metrics_of(bench, cell)
    if traced:
        assert set(line["metrics"]) <= {m["name"] for m in layer}
    else:
        assert set(line["metrics"]) == {m["name"] for m in e2e}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_a_check_over_its_limit_makes_the_run_incorrect(bench):
    out = _out(False)
    out["checks"][0] = ("features_differ", 1, 0)
    line = run_mod.result_line(bench, bench["workloads"][0], out, False, {})
    assert line["correct"] is False


def test_command_refuses_without_a_card(bench, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_mod.main(["--workload", bench["workloads"][0]["name"], "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
