"""The correctness check's control: the plain reference of the
configuration's sensor computed in bfloat16, the nearest precision below
the float32 the configuration's front-end states, put in the program's
place.

    python3 -m slambench.control --workload <name> --seeds <n> [<n> ...]

renders each seed's lap at the cell's own size, draws as many frames as a
run of the cell checks from the frames its window covers, hands the
control's features of those frames to the cell's own check
(`harness.check`, with the lap's ground-truth poses standing for the
tracker's) and prints, per seed, each number the check compared beside
its limit and the verdict `correct` that a run's result line would carry
(`run.correct_of`); it exits 1 if any seed's control comes out correct.
It also reads the float32 reference against itself run twice, the
reading of a sound program.  The benchmark's runs do not run it; it needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from slambench import harness
from slambench.run import correct_of


def ground_truth_poses(lap, ks) -> list:
    """[(k, pose)] with the tracker's pose convention: world-to-camera R, t."""
    out = []
    for k in ks:
        R_cw = lap.R_wc[k % len(lap)].T
        out.append((k, SimpleNamespace(R=R_cw, t=-R_cw @ lap.c_w[k % len(lap)])))
    return out


def control_checks(cfg: dict, lap, ks, device, seed: int) -> tuple:
    """(checks, sound): the cell's checks with the bfloat16 reference's
    features in the program's place on frames `ks`, and the float32
    reference's features_differ against itself."""
    sensor = harness.sensor_of(cfg)
    ctl = sensor.reference_of(cfg, device, torch.bfloat16)
    ref = sensor.reference_of(cfg, device)
    sampler = harness.Sampler(len(ks), seed, sensor.FIELDS)
    sound = 0
    for k in ks:
        got = sensor.unpack(harness.reference_block(ctl, lap, k))
        sampler.offer(k, SimpleNamespace(**got))
        sound += sensor.features_differ(harness.reference_block(ref, lap, k),
                                        sensor.unpack(harness.reference_block(ref, lap, k)))
    window = dict(poses=ground_truth_poses(lap, range(min(ks), max(ks) + 1)))
    return harness.check(cfg, lap, window, sampler, device), sound


def readings(bench: dict, cell_name: str, seed: int, device="cuda") -> dict:
    cell = harness.cell_of(bench, cell_name)
    cfg = harness.config_of(bench, cell)
    mix = harness.mix_of(cell["traffic"])
    lap = harness.sensor_of(cfg).render_lap(cfg, seed, device)
    first = mix["warmup_frames"]
    span = int(bench["run_seconds"] * mix.get("rate_hz", cfg["Camera.fps"]))
    ks = np.random.default_rng(seed).choice(np.arange(first, first + span),
                                            mix["check_frames"], replace=False)
    t0 = time.perf_counter()
    checks, sound = control_checks(cfg, lap, sorted(ks.tolist()), device, seed)
    return dict(seed=seed, frames=len(ks), correct=correct_of(checks),
                checks={n: {"value": v, "limit": lim} for n, v, lim in checks},
                sound_features_differ=sound, seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("slambench.control needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    rc = 0
    for seed in args.seeds:
        r = readings(bench, args.workload, seed)
        print(json.dumps(r), flush=True)
        rc |= r["correct"]
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
