"""Device time of work on the card, and the least time the card could take.

`device_ms` is the device time per call of a function, from CUDA events
around the replay of a CUDA graph of many calls; `cuda_ms` the median
window between CUDA events around one call; `device_profile` the
device-busy time of its ops from torch.profiler; `bound_ms` the larger of
the bytes over the memory rate and the operations over the peak rate of
their type.  Every function here needs a CUDA card.
"""

from __future__ import annotations

import statistics

import torch

# NVIDIA H100 SXM at its full 700 W power limit: the data sheet's HBM3
# rate, and an int32 rate of 132 SMs x 64 INT32 lanes (half the 128 FP32
# lanes behind the data sheet's 67 TFLOP/s float32) x 1.98 GHz x 2, since
# the three-input IADD3 / IMAD / VIMNMX3 instructions each do two two-input
# operations (sm_90a compiles B1's 272 two-input min/max per pixel to 144
# VIMNMX3).  Operations are counted as two-input integer operations.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 2 * 132 * 64 * 1.98e9
# signed 16-bit lanes packed two to a register (__vsub2 / __vmins2 /
# __vmaxs2): two operations per lane op
INT16X2_OPS_PER_S = 2 * INT32_OPS_PER_S

# The least two-input integer operations per pixel of the FAST-9/16 score
# minus 1, whichever kernel computes it (B1, B3, T1-T4): the 16 ring
# differences; per polarity a van Herk window-9 min over the circular ring
# (58) and the max over its 16 windows (15); the fold of the two
# polarities, one negation and the -1.  Differences lie in [-255, 255], so
# every operation fits a 16-bit lane: count them at INT16X2_OPS_PER_S.
FAST_SCORE_OPS_PER_PX = 16 + 2 * (58 + 15) + 3

REPS = 30
PROFILE_TRIES = 6
NO_TRACE = ("the profiler's traces held no device event: the busy time below is not "
            "measured")


def bound_ms(n_bytes: float, ops: float = 0.0, ops_per_s: float = INT32_OPS_PER_S) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take to
    move `n_bytes` and do `ops` operations of a type it runs at `ops_per_s`."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median device time of fn() in ms (CUDA events, after warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(fn, reps: int = 10):
    """(event ms per call, {op: device ms per call}, device ops launched
    per call) of fn() under torch.profiler: kernels, memcpys, memsets.

    Now and then the profiler's trace comes back holding no device event at
    all (on an H100 about 3 sessions in 1000, often two or three in a row);
    every fn profiled here launches device work, so such a session is run
    again, up to PROFILE_TRIES times.  If every one came back empty, the
    dict is empty and the caller says the time was not measured.  Late in
    a long process a trace can also miss launches (on an H100, 4 of 10
    recorded), which is why `device_ms` does not use the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
        # device-side events only (kernels, memcpy, memset): the CPU ops that
        # launched them carry the same time again, and a record_function range
        # shows on the device too, under its CPU name, spanning its kernels
        avgs = prof.key_averages()
        cpu_keys = {a.key for a in avgs if a.device_type == DeviceType.CPU}
        dev = [
            a for a in avgs
            if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0
            and a.key not in cpu_keys
        ]
        if dev:
            break
    ops = {a.key: a.self_device_time_total / 1e3 / reps for a in dev}
    return start.elapsed_time(end) / reps, ops, sum(a.count for a in dev) / reps


def device_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Median device time per call of fn() in ms: CUDA events around the
    replay of one CUDA graph that holds `calls` calls, so the card runs
    them back to back with no host launch gaps (it holds the ~1 us between
    launches).  Raises if fn cannot be captured (a host synchronisation
    inside it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as graph capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)
