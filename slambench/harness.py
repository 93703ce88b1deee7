"""One run of one cell: set-up, the measured window, the checks.

Everything a cell needs is found by name: its configuration in
`configs/<config>.json` and the sensor that configuration names in
`sensors/<sensor>.py` (its frames, its System, its entry point, its plain
reference), its traffic in `traffic/<mix>.json` and the loop that mix names
in `loops/<loop>.py`, each per-layer metric's reader in
`metrics/<metric>.py`, the lap's path in `world/laps/<kind>.py`.  The
program (`orbslam3_tpu_torch`) is driven only through its public `System`
entry points; from it the benchmark reads its own records (the `Benchmark`
tags it writes) and the frame the tracker consumed
(`System.tracker.current`).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from slambench import trace as tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# what a cell's check compares, with the limit each is held to
FEATURE_LIMIT = 0  # the front-end's features are integer work and one f32 program: exact
NO_ATE = 1e9  # metres: the ATE of a window with fewer than three poses


# --- the catalog --------------------------------------------------------------

def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    cells = [c for c in bench["workloads"] if c["name"] == name]
    if len(cells) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return cells[0]


def config_of(bench: dict, cell: dict, root: Path = ROOT) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(root / entry["file"]) as f:
        return json.load(f)


def mix_of(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def sensor_of(cfg: dict):
    """The module sensors/<sensor>.py that the configuration's `sensor` key names."""
    name = f"slambench.sensors.{cfg['sensor']}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as exc:
        if exc.name != name:
            raise
        raise ModuleNotFoundError(
            f"configuration {cfg['name']!r} names the sensor {cfg['sensor']!r}, and there is "
            f"no file slambench/sensors/{cfg['sensor']}.py", name=name) from None


def loop_of(mix: dict):
    """The module loops/<loop>.py that the mix's `loop` key names."""
    return importlib.import_module(f"slambench.loops.{mix['loop']}")


def reader_of(metric: str):
    """The `read(run)` function of metrics/<metric>.py."""
    spec = importlib.util.spec_from_file_location(
        f"slambench_metric_{metric.replace('.', '_')}", HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: dict) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries this cell reports."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]
    return e2e, layer


# --- the lap --------------------------------------------------------------------

class Lap:
    """The rendered lap on the host: images (N, views, h, w) uint8, each
    frame's views as its sensor orders them (a stereo pair: left, right),
    and the left camera's ground truth, rotations R_wc (N, 3, 3) and centres
    (N, 3).  A sensor whose entry takes more per frame, such as the IMU
    samples since the last frame, keeps it on the lap beside them."""

    def __init__(self, images: np.ndarray, R_wc: np.ndarray, c_w: np.ndarray):
        self.images, self.R_wc, self.c_w = images, R_wc, c_w

    def __len__(self) -> int:
        return len(self.images)

    def views(self, k: int) -> np.ndarray:
        """Lap frame k's views; frame k + len is frame k again."""
        return self.images[k % len(self)]


def reference_block(ref, lap: Lap, k: int) -> np.ndarray:
    """The plain reference's packed features of lap frame k's views."""
    return ref(torch.from_numpy(lap.views(k)).to(ref.device)).cpu().numpy()


def train_vocabulary(cfg: dict, lap: Lap, device):
    """The bag-of-words vocabulary, trained at set-up on the descriptors the
    plain reference extracts from frames spread evenly over the lap."""
    from orbslam3_tpu_torch.vocab.vocabulary import BinaryVocabulary

    voc = cfg["vocabulary"]
    ks = np.linspace(0, len(lap), voc["train_frames"], endpoint=False).astype(int)
    descs = sensor_of(cfg).training_descriptors(cfg, lap, ks, device)
    return BinaryVocabulary.train(descs, k=voc["k"], depth=voc["depth"], seed=0)


# --- the window ---------------------------------------------------------------

class Sampler:
    """A uniform sample, drawn from the seed, of the frames the tracker read
    in the window (reservoir sampling): {frame index: its features}, the
    frame's attributes that the sensor's check reads (`fields`)."""

    def __init__(self, size: int, seed: int, fields: tuple):
        self.size = size
        self.fields = fields
        self.rng = np.random.default_rng(seed)
        self.seen = 0
        self.kept: dict = {}

    def offer(self, k: int, frame) -> None:
        i = self.seen
        self.seen += 1
        if i < self.size:
            slot = None
        else:
            j = int(self.rng.integers(0, i + 1))
            if j >= self.size:
                return
            slot = sorted(self.kept)[j]
        if slot is not None:
            del self.kept[slot]
        self.kept[k] = {f: np.array(getattr(frame, f)) for f in self.fields}


class Tracer:
    """torch.profiler over the window, and the program's records taken
    while it ran."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.device = device
        self.range = None
        self.records = None
        self.host: dict = {}
        self.path = None

    def start(self) -> None:
        """The profiler started before the window: its start takes seconds."""
        self.prof.start()

    def begin(self, t0: float) -> None:
        """The traced window opens at the window's start, t0."""
        self.marks = _record_counts()
        self.range = torch.profiler.record_function(tracing.WINDOW)
        self.range.__enter__()

    def stop(self, host: dict) -> None:
        """The window has closed: stop, keep its records and host spans,
        export the trace under TMPDIR."""
        self.range.__exit__(None, None, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.records = _records_since(self.marks)
        self.host = {k: list(v) for k, v in host.items()}
        fd, self.path = tempfile.mkstemp(prefix="slambench_", suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(self.path)


def _record_counts() -> dict:
    from orbslam3_tpu_torch.utils.benchmark import Benchmark

    return {tag: len(v) for tag, v in Benchmark.the().records.items()}


def _records_since(marks: dict) -> dict:
    from orbslam3_tpu_torch.utils.benchmark import Benchmark

    return {tag: list(v[marks.get(tag, 0):]) for tag, v in Benchmark.the().records.items()}


def describe(system, window: dict) -> str:
    """One line on the window: call times, latency, the map and its threads."""
    calls = np.asarray(next((v for v in window["host"].values() if v), [0.0]))
    st = system.map_stats()
    lm, lc = system.local_mapper, system.loop_closer
    text = (f"calls ms: median {np.median(calls):.2f} p95 {np.percentile(calls, 95):.2f} "
            f"max {calls.max():.2f} sum {calls.sum() / 1e3:.2f} s; keyframes {st['n_keyframes']}, "
            f"map points {st['n_map_points']}, maps {system.atlas.count_maps()}, local BA "
            f"{lm.n_lba_exec}/{lm.n_lba_abort} run/aborted, loops "
            f"{lc.n_loops_closed if lc is not None else 0}")
    if "latency_s" in window:
        lat = np.asarray(window["latency_s"]) * 1e3
        text += (f"; latency ms: median {np.median(lat):.2f} p95 {np.percentile(lat, 95):.2f} "
                 f"max {lat.max():.2f}, {int((lat > 100).sum())} over 100 ms")
    return text


# --- the check ------------------------------------------------------------------

def ate_rmse(est_c: np.ndarray, gt_c: np.ndarray) -> float:
    """RMS of the camera centres' error after the rigid (Umeyama) alignment."""
    mu_e, mu_g = est_c.mean(0), gt_c.mean(0)
    xe, xg = est_c - mu_e, gt_c - mu_g
    u, _, vt = np.linalg.svd(xg.T @ xe / len(xe))
    s = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    aligned = est_c @ r.T + (mu_g - r @ mu_e)
    return float(np.sqrt(np.mean(np.sum((aligned - gt_c) ** 2, axis=1))))


def check(cfg: dict, lap: Lap, window: dict, sampler: Sampler, device) -> list:
    """[(name, value, limit)]: the sampled frames' features against the
    sensor's plain reference on the same frames (`features_differ`), and the
    returned poses against the lap's ground truth."""
    sensor = sensor_of(cfg)
    ref = sensor.reference_of(cfg, device)
    differ = 0
    for k, got in sorted(sampler.kept.items()):
        differ += sensor.features_differ(reference_block(ref, lap, k), got)
    tracked = [(k, p) for k, p in window["poses"] if p is not None]
    acc = cfg["accuracy"]
    if len(tracked) >= 3:
        est = np.stack([-p.R.T @ p.t for _, p in tracked])
        gt = np.stack([lap.c_w[k % len(lap)] for k, _ in tracked])
        ate = ate_rmse(est, gt)
    else:
        ate = NO_ATE
    untracked = 1.0 - len(tracked) / max(len(window["poses"]), 1)
    return [
        ("features_differ", differ, FEATURE_LIMIT),
        ("ate_m", ate, acc["ate_m"]),
        ("untracked_share", untracked, acc["untracked_share"]),
    ]


# --- the run ----------------------------------------------------------------------

def end_to_end(window: dict, setup_s: float) -> dict:
    """The window's end-to-end metrics: `frame_ms_mean`, the mean over every
    frame of the window of the time the System took to return its pose
    once handed the frame (the open loop's `frame_ms`), and `setup_s`."""
    out = {"setup_s": (setup_s, "s")}
    calls = window["host"].get("frame_ms")
    if calls:
        out["frame_ms_mean"] = (statistics.fmean(calls), "ms")
    return out


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, traced: bool,
             t_start: float, device="cuda", cfg: dict | None = None, mix: dict | None = None,
             log=print) -> dict:
    """One run of the cell; returns the result line's fields and the checks."""
    device = torch.device(device)
    cell = cell_of(bench, cell_name)
    cfg = cfg if cfg is not None else config_of(bench, cell)
    mix = mix if mix is not None else mix_of(cell["traffic"])
    fps = float(cfg["Camera.fps"])
    loop = loop_of(mix)
    sensor = sensor_of(cfg)
    lap = sensor.render_lap(cfg, seed, device)
    vocabulary = train_vocabulary(cfg, lap, device)
    system = sensor.make_system(cfg, vocabulary, device)
    k0 = loop.warm_up(system, sensor, lap, mix, fps)
    sampler = Sampler(mix["check_frames"], seed, sensor.FIELDS)
    tracer = Tracer(device) if traced else None
    if tracer:
        tracer.start()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    window = loop.run(system, sensor, lap, k0, mix, fps, seconds, sampler, tracer)
    if tracer:
        tracer.stop(window["host"])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(describe(system, window))
    system.shutdown()
    frames = [k for k, _ in window["poses"]]
    failed = sum(p is None for _, p in window["poses"])
    del system
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(cfg, lap, window, sampler, device)
    if "late_s" in window and window["late_s"]:
        late = np.asarray(window["late_s"]) * 1e3
        log(f"generator lateness: mean {late.mean():.3f} ms, max {late.max():.3f} ms "
            f"over {len(late)} frames sent on time")
    log(f"frames {len(frames)} (lap frames {frames[0]}-{frames[-1]}, "
        f"{(frames[-1] - frames[0] + 1) / len(lap):.2f} laps of {len(lap)}), "
        f"failed {failed}; checked {len(sampler.kept)} frames")
    out = dict(attempted=window["attempted"], failed=failed, checks=checks, peak=peak,
               e2e=end_to_end(window, setup_s), window=window, setup_s=setup_s)
    if traced:  # what the per-layer readers read
        out["run"] = dict(cfg=cfg, mix=mix, records=tracer.records, host=tracer.host,
                          trace=tracing.read(tracer.path) if tracer.path else None,
                          least_s=sensor.least_seconds(cfg))
    return out
