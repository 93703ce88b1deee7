"""The sweep that found the live mix's rate: the highest rate at which the
System keeps up with an open loop, and so where four fifths of it lies.

    python3 -m slambench.sweep --workload <cell> --seed <n> --seconds <s> --rates <hz> [<hz> ...]

renders the cell's lap and trains its vocabulary once, then for each rate
builds a fresh threaded System, warms it up and offers frames at that rate
through the cell's loop for `--seconds`, and prints one JSON line a rate:
the latency's median, 95th percentile and maximum, the calls' median and
95th percentile, the share of the window spent in calls, and the median
latency of the window's first and last quarter (a queue that grows through
the window shows as a last quarter far above the first).  It checks
nothing; it needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from slambench import harness


def one_rate(cfg: dict, lap, vocabulary, mix: dict, rate: float, seconds: float, seed: int,
             device="cuda") -> dict:
    mix = dict(mix, rate_hz=rate)
    loop = harness.loop_of(mix)
    sensor = harness.sensor_of(cfg)
    fps = float(cfg["Camera.fps"])
    system = sensor.make_system(cfg, vocabulary, torch.device(device))
    k0 = loop.warm_up(system, sensor, lap, mix, fps)
    window = loop.run(system, sensor, lap, k0, mix, fps, seconds,
                      harness.Sampler(0, seed, sensor.FIELDS), None)
    st = system.map_stats()
    system.shutdown()
    lat = np.asarray(window["latency_s"]) * 1e3
    calls = np.asarray(window["host"]["frame_ms"])
    q = len(lat) // 4
    return dict(
        rate_hz=rate, frames=len(lat),
        failed=sum(p is None for _, p in window["poses"]),
        latency_ms=dict(median=float(np.median(lat)), p95=float(
            statistics.quantiles(sorted(lat), n=100, method="inclusive")[94]), max=float(lat.max())),
        calls_ms=dict(median=float(np.median(calls)), p95=float(np.percentile(calls, 95))),
        busy_share=float(calls.sum() / 1e3 / seconds),
        quarter_median_ms=[float(np.median(lat[:q])), float(np.median(lat[-q:]))],
        keyframes=st["n_keyframes"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("slambench.sweep needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    cell = harness.cell_of(bench, args.workload)
    cfg = harness.config_of(bench, cell)
    mix = harness.mix_of(cell["traffic"])
    t0 = time.perf_counter()
    lap = harness.sensor_of(cfg).render_lap(cfg, args.seed, "cuda")
    vocabulary = harness.train_vocabulary(cfg, lap, "cuda")
    print(f"card: {torch.cuda.get_device_name(0)}; lap and vocabulary in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for rate in args.rates:
        print(json.dumps(one_rate(cfg, lap, vocabulary, mix, rate, args.seconds, args.seed)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
