"""Reading a torch.profiler trace of the traced window.

The arithmetic is that of the port's `tools/trace_ops.py` (device
intervals in start order, a gap is the time from the end of the work
before to the start of the next, busy time is what the intervals cover),
copied so that later changes to the program cannot move the yardstick.
The trace is the profiler's Chrome-trace export: "X" events, device work
under the categories below, host ranges (`torch.profiler.record_function`,
the program's `trace_range` tags and the benchmark's own) as
"user_annotation", and launches as "cuda_runtime" / "cuda_driver" events
that share a "correlation" id with the device work they queued.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "slambench.window"


def load(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


class Trace:
    """The traced window's device work and host ranges, times in us."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if len(win) != 1:
            raise ValueError(f"the trace holds {len(win)} '{WINDOW}' ranges, not one")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.main_tid = win[0].get("tid")
        self.device = [
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""),
             e.get("cat"), (e.get("args") or {}).get("correlation"))
            for e in xs if e.get("cat") in DEVICE_CATS
        ]
        self.launches = [
            (float(e["ts"]), e.get("tid"), (e.get("args") or {}).get("correlation"))
            for e in xs if e.get("cat") in LAUNCH_CATS
        ]
        self.ranges = [
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""),
             e.get("tid"))
            for e in xs if e.get("cat") == "user_annotation" and e.get("name") != WINDOW
        ]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _in_window(self):
        for s, e, name, cat, corr in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                yield s, e, name, cat, corr

    def busy_s(self) -> float:
        """Seconds of the window in which a kernel or a copy ran."""
        return covered((s, e) for s, e, *_ in self._in_window()) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device work that took most time."""
        per: dict = defaultdict(float)
        for s, e, name, _, _ in self._in_window():
            per[name] += e - s
        return [[n, t * 1e-6] for n, t in sorted(per.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host range, seconds]]: the window's idle device time, each gap
        put under the innermost range of the main thread open at its middle
        (the host's work at the time), summed by range, largest first."""
        busy = union((s, e) for s, e, *_ in self._in_window())
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        # one thread's ranges nest: a sweep keeps the open ones on a stack
        main = sorted((r for r in self.ranges if r[3] == self.main_tid),
                      key=lambda r: (r[0], -r[1]))
        per: dict = defaultdict(float)
        stack: list = []
        i = 0
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            while i < len(main) and main[i][0] <= mid:
                while stack and stack[-1][1] <= main[i][0]:
                    stack.pop()
                stack.append(main[i])
                i += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            per[stack[-1][2] if stack else "<no range>"] += b - a
        return [[n, t * 1e-6] for n, t in sorted(per.items(), key=lambda kv: -kv[1])[:top]]

    def work_of(self, range_name: str) -> list:
        """Per host range of this name on the main thread inside the window:
        the device work its launches queued, [(start, end, name, cat)]."""
        by_corr: dict = defaultdict(list)
        for s, e, name, cat, corr in self.device:
            if corr is not None:
                by_corr[corr].append((s, e, name, cat))
        launches = sorted((t, c) for t, tid, c in self.launches if tid == self.main_tid)
        times = [t for t, _ in launches]
        out = []
        for s, e, name, tid in self.ranges:
            if name != range_name or tid != self.main_tid or s < self.t0 or e > self.t1:
                continue
            lo, hi = bisect.bisect_left(times, s), bisect.bisect_right(times, e)
            work = [w for _, c in launches[lo:hi] for w in by_corr.get(c, ())]
            if work:
                out.append(sorted(work))
        return out


def read(path: str) -> Trace:
    """The Trace of the profiler's export at `path`; the file is removed."""
    try:
        return Trace(load(path))
    finally:
        os.remove(path)
