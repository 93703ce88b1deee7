"""Timing instrumentation: spans on every thread, kept as records and in a ring.

Role-parity with the reference's orb_benchmark library
(ORB_SLAM3/include/orb/Benchmark.h, src/Benchmark/src/Benchmark.cpp) and
its NVTX PUSH_RANGE/POP_RANGE (ORB_SLAM3/include/Utils.hpp:17-38).  A span
is a named interval of work on one thread.  Each is kept twice:

- its duration in ms under its name in `Benchmark.records` (tag -> list),
  what per-stage means are read from;
- a tuple (`Span`'s fields) in the bounded ring `Benchmark.spans`: name,
  start and end, thread, parent (the span open on the same thread when it
  began) and the id of the frame the work serves (inherited from the
  parent unless given).  `Benchmark.export_chrome_trace` writes the ring as a Chrome
  trace (Perfetto, chrome://tracing).

Spans are always on.  `trace_range` also opens a `torch.profiler` range
while a profiler runs (and an NVTX range on CUDA); with no profiler it
costs a few microseconds.  `push_sample` records a span after the fact,
from a start and a duration the caller measured (a CUDA-event window, a
queue wait); `off_cpu` records the time a block's thread spent off the CPU.

One clock, `clock_ns` (CLOCK_REALTIME, ns since the epoch), times every
span of the process.  It is the clock of torch.profiler's Chrome-trace
export, whose `ts` is (clock_ns() - baseTimeNanoseconds) / 1000 us, with
`baseTimeNanoseconds` a key of that export's JSON (absent, read as 0, on
torch builds that write epoch microseconds): export the spans with
`base_ns` set to it and both traces share one time axis.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import NamedTuple

import torch
from torch.cuda import nvtx as _nvtx

clock_ns = time.time_ns
_profiler_enabled = torch._C._autograd._profiler_enabled
# spans the ring keeps: a traced EuRoC window (about 13 a frame on the
# tracker's thread, 20 frames a second, 51 s, plus the mapping threads')
# fits several times over
RING_SPANS = 1 << 16


class Span(NamedTuple):
    """The fields of a span as the ring keeps them, a plain tuple in this
    order (`Span(*t)` names them)."""

    name: str
    start_ns: int
    end_ns: int
    tid: int  # the thread's native id, as torch.profiler's `tid`
    id: int
    parent: int | None  # id of the span open on the thread when it began
    frame: int | None  # id of the frame the work serves


_tls = threading.local()
_thread_names: dict = {}  # native thread id -> the thread's name


def _stack() -> list:
    """This thread's open spans, innermost last, as (id, frame)."""
    try:
        return _tls.stack
    except AttributeError:
        _tls.tid = threading.get_native_id()
        _thread_names[_tls.tid] = threading.current_thread().name
        _tls.stack = []
        return _tls.stack


class _Records(defaultdict):
    """Tag -> durations in ms.  Every thread adds tags while a reader loops
    over them: `items()` is a list taken in one step, which no thread
    switch interrupts, so the loop never sees the dict change size."""

    def items(self):
        return list(dict.items(self))


class Benchmark:
    _instance = None

    def __init__(self):
        self.records: dict[str, list[float]] = _Records(list)
        self.spans: deque = deque(maxlen=RING_SPANS)
        self._next_id = itertools.count(1).__next__  # atomic under the GIL

    @classmethod
    def the(cls) -> "Benchmark":
        """Process-wide instance (Benchmark::the, Benchmark.cpp:6)."""
        if cls._instance is None:
            cls._instance = Benchmark()
        return cls._instance

    def measure(self, tag: str) -> "_Range":
        """A span around a block, recorded under `tag`."""
        return _Range(self, tag, None)

    def push_sample(self, tag: str, ms: float, start_ns: int | None = None,
                    frame: int | None = None):
        """Record a span the caller measured: `ms` long, from `start_ns`
        (on `clock_ns`; by default it ends now).  Its parent is the span
        open on this thread now (System::Insert*Time / REGISTER_TIMES
        role)."""
        ms = float(ms)
        stack = _stack()
        parent, inherited = stack[-1] if stack else (None, None)
        if start_ns is None:
            start_ns = clock_ns() - int(ms * 1e6)
        self.records[tag].append(ms)
        self.spans.append((tag, start_ns, start_ns + int(ms * 1e6), _tls.tid, self._next_id(),
                           parent, inherited if frame is None else frame))

    def export_chrome_trace(self, path: str, base_ns: int = 0):
        """The ring as Chrome-trace JSON: an "X" event per span, `ts` and
        `dur` in us with `ts` = (start - base_ns) / 1000, the span's id,
        parent, frame and thread name in `args`, and each thread's name."""
        pid = os.getpid()
        events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": name}} for tid, name in list(_thread_names.items())]
        events += [
            {"ph": "X", "cat": "span", "name": name, "pid": pid, "tid": tid,
             "ts": (t0 - base_ns) / 1e3, "dur": (t1 - t0) / 1e3,
             "args": {"id": sid, "parent": parent, "frame": frame,
                      "thread": _thread_names.get(tid)}}
            for name, t0, t1, tid, sid, parent, frame in list(self.spans)
        ]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": base_ns}, f)


class _Range:
    """A span around a `with` block, and a torch.profiler range while a
    profiler runs (with `nvtx`, an NVTX range too)."""

    __slots__ = ("bench", "name", "frame", "nvtx", "_rf", "_id", "_parent", "_t0")

    def __init__(self, bench: Benchmark, name: str, frame, nvtx: bool = False):
        self.bench, self.name, self.frame, self.nvtx = bench, name, frame, nvtx
        self._rf = None

    def __enter__(self):
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self.nvtx:
            _nvtx.range_push(self.name)
        stack = _stack()
        self._parent, inherited = stack[-1] if stack else (None, None)
        if self.frame is None:
            self.frame = inherited
        self._id = self.bench._next_id()
        stack.append((self._id, self.frame))
        self._t0 = clock_ns()
        return self

    def __exit__(self, *exc):
        t1 = clock_ns()
        _tls.stack.pop()
        self.bench.records[self.name].append((t1 - self._t0) / 1e6)
        self.bench.spans.append((self.name, self._t0, t1, _tls.tid, self._id, self._parent,
                                 self.frame))
        if self.nvtx:
            _nvtx.range_pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def trace_range(name: str, device=None, frame: int | None = None) -> _Range:
    """A span of the process-wide Benchmark around a `with` block, and a
    named range in the profiler's timeline while a profiler runs (and an
    NVTX range when `device` is CUDA): PUSH_RANGE/POP_RANGE for a stage.
    `frame`: the id of the frame the work serves (default: the enclosing
    span's)."""
    nvtx = device is not None and (
        device.type if isinstance(device, torch.device) else torch.device(device).type) == "cuda"
    return _Range(Benchmark.the(), name, frame, nvtx)


class off_cpu:
    """After a `with` block, a span under `tag` of its wall time minus its
    thread's CPU time (`time.thread_time_ns`) over it: the time the thread
    waited (a lock, the interpreter lock, I/O), from the block's start."""

    __slots__ = ("tag", "_t0", "_cpu0")

    def __init__(self, tag: str):
        self.tag = tag

    def __enter__(self):
        self._t0, self._cpu0 = clock_ns(), time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        waited = (clock_ns() - self._t0) - (time.thread_time_ns() - self._cpu0)
        Benchmark.the().push_sample(self.tag, max(waited, 0) / 1e6, self._t0)
        return False


@contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of everything inside the block (host
    ops, and the card's kernels and copies when CUDA is available) into a
    ``*.pt.trace.json`` file under `log_dir` (PUSH_RANGE-session analog)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield

