"""Open loop: frames due at the mix's `rate_hz`, one at a time through the
sensor's entry point (`sensor.track`), as a live camera hands them over;
each frame's latency runs from its due time.  The frames carry the
camera's own timestamps, k / Camera.fps."""

from __future__ import annotations

import time

import torch


def warm_up(system, sensor, lap, mix: dict, fps: float) -> int:
    """The warm-up frames due at the mix's rate: the graph's capture, the
    map's initialisation.  Returns the next lap frame."""
    n, rate = mix["warmup_frames"], float(mix["rate_hz"])
    t0 = time.perf_counter()
    for k in range(n):
        time.sleep(max(0.0, t0 + k / rate - time.perf_counter()))
        sensor.track(system, lap, k, k / fps)
    return n


def run(system, sensor, lap, k0: int, mix: dict, fps: float, seconds: float, sampler,
        tracer) -> dict:
    rate = float(mix["rate_hz"])
    n = int(round(seconds * rate))
    poses, latency, late = [], [], []
    host: dict = {"frame_ms": []}
    t0 = time.perf_counter() + 0.05
    if tracer:
        tracer.begin(t0)
    busy_until = t0
    for i in range(n):
        k = k0 + i
        due = t0 + i / rate
        now = time.perf_counter()
        if now < due:
            with torch.profiler.record_function("slambench.wait"):
                time.sleep(due - now)
        start = time.perf_counter()
        if busy_until <= due:  # the generator's own lateness, not the queue's
            late.append(start - due)
        try:
            pose = sensor.track(system, lap, k, k / fps)
        except Exception as exc:  # noqa: BLE001 — a raising call counts as failed
            print(f"frame {k}: {type(exc).__name__}: {exc}", flush=True)
            pose = None
        end = time.perf_counter()
        busy_until = end
        latency.append(end - due)
        host["frame_ms"].append((end - start) * 1e3)
        poses.append((k, pose))
        sampler.offer(k, system.tracker.current)
    return dict(poses=poses, latency_s=latency, late_s=late, window_s=seconds, host=host,
                attempted=n)
