"""Run one cell of the benchmark once.

    python3 -m slambench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card.  The last line
of standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its per-layer
metrics), `device`, with `--trace 1` a `breakdown`, and last `checks`, each
number the check compared beside its limit (also the last lines of
standard error).  Without a card, or with fewer cards than the cell asks
for, it prints no result and exits 2; if jax, jaxlib, flax or the JAX
package is loaded once the window has closed, it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "orbslam3_tpu")
# One thread in each native pool, set before numpy and torch load: the
# System's host work is Python threads (tracking, mapping, loop closing),
# and BLAS / OpenMP pools spinning beside them make runs spread.
BLAS_THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def correct_of(checks: list) -> bool:
    """A run is correct when every number its check compared is within its limit."""
    return all(v <= lim for _, v, lim in checks)


def result_line(bench: dict, cell: dict, out: dict, traced: bool, device: dict) -> dict:
    from slambench import harness

    e2e, layer = harness.metrics_of(bench, cell)
    metrics = {}
    if traced:
        run = out["run"]
        for m in layer:
            value = harness.reader_of(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            value, unit = out["e2e"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}
    checks = out["checks"]
    line = {
        "correct": correct_of(checks),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": device,
    }
    if traced and out["run"]["trace"] is not None:
        tr = out["run"]["trace"]
        line["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var in BLAS_THREADS:
        os.environ.setdefault(var, "1")
    import torch

    from slambench import harness

    bench = harness.load_benchmark()
    cell = harness.cell_of(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"slambench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                           T_START)
    found = forbidden_modules()
    if found:
        print(f"slambench: loaded in the run's process: {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(out["peak"])}
    if args.trace:
        tr = out["run"]["trace"]
        device["busy_s"] = tr.busy_s() if tr is not None else 0.0
        device["window_s"] = tr.window_s if tr is not None else 0.0
    line = result_line(bench, cell, out, bool(args.trace), device)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
