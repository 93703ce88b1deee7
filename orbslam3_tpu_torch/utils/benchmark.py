"""Timing instrumentation: measured calls, double-buffered queue, CSV drain.

Role-parity with the reference's orb_benchmark library
(ORB_SLAM3/include/orb/Benchmark.h, src/Benchmark/src/Benchmark.cpp)
and Util/CSVLogger.h: `measure` wraps any call and records (tag, wall
duration); a double-buffered, lock-protected queue decouples the hot path
from the writer thread that drains to CSV; `summary()` reproduces the
mean +/- std per-stage report the reference writes to ExecMean.txt
(Tracking::PrintTimeStats role).
"""

from __future__ import annotations

import atexit
import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class DBQueue:
    """Double-buffered queue (orb::DBQueue, Benchmark.h:19-59)."""

    def __init__(self):
        self._front: list = []
        self._back: list = []
        self._lock = threading.Lock()

    def push(self, item):
        with self._lock:
            self._front.append(item)

    def swap_and_drain(self) -> list:
        with self._lock:
            self._front, self._back = self._back, self._front
        out = self._back
        self._back = []
        return out


class Benchmark:
    _instance = None

    def __init__(self, csv_path: str | None = None, flush_interval: float = 1.0):
        self.queue = DBQueue()
        self.records: dict[str, list[float]] = defaultdict(list)
        self.csv_path = csv_path
        self.enabled = True
        self._stop = False
        self._writer = None
        if csv_path:
            self._writer = threading.Thread(target=self._drain_loop, args=(flush_interval,), daemon=True)
            self._writer.start()
            atexit.register(self.shutdown)

    @classmethod
    def the(cls) -> "Benchmark":
        """Process-wide instance (Benchmark::the, Benchmark.cpp:6)."""
        if cls._instance is None:
            cls._instance = Benchmark()
        return cls._instance

    # ------------------------------------------------------------------
    @contextmanager
    def measure(self, tag: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            self.queue.push((tag, time.time(), dt))
            self.records[tag].append(dt)

    def push_sample(self, tag: str, ms: float):
        """Record an externally-measured duration under `tag`
        (System::Insert*Time / REGISTER_TIMES vector-push role)."""
        if not self.enabled:
            return
        self.queue.push((tag, time.time(), float(ms)))
        self.records[tag].append(float(ms))

    def measure_function(self, tag: str):
        """Decorator form (MEASURE_FUNC_CALL role)."""

        def deco(fn):
            def wrapped(*a, **kw):
                with self.measure(tag):
                    return fn(*a, **kw)

            return wrapped

        return deco

    # ------------------------------------------------------------------
    def _drain_loop(self, interval: float):
        with open(self.csv_path, "w") as f:
            f.write("tag,timestamp,duration_ms\n")
            while not self._stop:
                time.sleep(interval)
                for tag, ts, dt in self.queue.swap_and_drain():
                    f.write(f"{tag},{ts:.6f},{dt:.4f}\n")
                f.flush()
            for tag, ts, dt in self.queue.swap_and_drain():
                f.write(f"{tag},{ts:.6f},{dt:.4f}\n")

    def shutdown(self):
        self._stop = True
        if self._writer is not None and self._writer.is_alive():
            self._writer.join(timeout=3)

    # ------------------------------------------------------------------
    def summary(self) -> dict[str, tuple[float, float, int]]:
        """tag -> (mean ms, std ms, count) — the ExecMean.txt report."""
        import numpy as np

        return {
            tag: (float(np.mean(v)), float(np.std(v)), len(v))
            for tag, v in sorted(self.records.items())
        }

    def write_exec_mean(self, path: str):
        with open(path, "w") as f:
            for tag, (mu, sd, n) in self.summary().items():
                f.write(f"{tag}: {mu:.4f}$\\pm${sd:.4f} (n={n})\n")


# ---------------------------------------------------------------------------
# device-profiler hooks (the reference's NVTX PUSH_RANGE/POP_RANGE analog,
# ORB_SLAM3/include/Utils.hpp:17-38 — here torch.profiler, whose
# traces open in Perfetto / chrome://tracing, plus NVTX ranges on CUDA)
# ---------------------------------------------------------------------------

@contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of everything inside the block (host
    ops, and the card's kernels and copies when CUDA is available) into a
    ``*.pt.trace.json`` file under `log_dir` (PUSH_RANGE-session analog)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextmanager
def trace_range(name: str, device=None):
    """Named range visible in the profiler timeline (and as an NVTX range
    when `device` is CUDA) AND recorded in the host Benchmark
    (PUSH_RANGE/POP_RANGE role for a single stage)."""
    import torch

    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            with Benchmark.the().measure(name):
                yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def annotate_function(name: str, device=None):
    """Decorator form of trace_range (MEASURE_*+NVTX combined)."""

    def deco(fn):
        def wrapped(*a, **kw):
            with trace_range(name, device):
                return fn(*a, **kw)

        return wrapped

    return deco


class Verbose:
    """Leveled stdout logger (System.h:47-72 Verbose role)."""

    QUIET, NORMAL, VERBOSE, VERY_VERBOSE, DEBUG = 0, 1, 2, 3, 4
    level = NORMAL

    @classmethod
    def print(cls, msg: str, level: int = 1):
        if level <= cls.level:
            print(msg)
