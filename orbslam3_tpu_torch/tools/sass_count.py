"""Static SASS instruction counts of the hand-written kernels.

    python -m orbslam3_tpu_torch.tools.sass_count [--lib PATH] [--px NAME=N ...]

Builds the kernel library from ``csrc/`` (or takes the shared library at
``--lib``), disassembles it with the CUDA toolkit's ``cuobjdump -sass`` and
prints, for each kernel, its SASS instructions (NOPs left out), the
instructions per pixel for a kernel whose pixels per thread are known
(``--px`` adds or overrides one: a substring of the kernel's name, then the
pixels one thread scores), and its most frequent opcodes.  A kernel whose
body is fully unrolled executes about its static count; a loop that is not
unrolled runs its body more often than the count says.  Needs the CUDA
toolkit; the last line is a JSON list of the counts.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

# pixels one thread scores, by a substring of the kernel's mangled name
PX_PER_THREAD = {
    "fast_score_kernel": 8,
    "detect_select_kernel": 4,
    "nms3_kernel": 4,
}

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)")


def cuobjdump() -> str:
    from orbslam3_tpu_torch import _build

    return str(Path(_build._nvcc()).with_name("cuobjdump"))


def parse_sass(text: str) -> dict:
    """{mangled kernel name: Counter of opcodes} of `cuobjdump -sass` output."""
    kernels: dict = {}
    current = None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = kernels.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSTRUCTION.match(line)
        if m and current is not None and m.group(1) != "NOP":
            current[m.group(1)] += 1
    return kernels


def counts(lib: str, px: dict) -> list:
    out = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True, check=True,
                         timeout=300)
    rows = []
    for name, ops in sorted(parse_sass(out.stdout).items()):
        n = sum(ops.values())
        per = next((v for k, v in px.items() if k in name), None)
        rows.append(dict(kernel=name, instructions=n, px_per_thread=per,
                         per_px=None if per is None else n / per,
                         top=ops.most_common(12)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", help="kernel library to disassemble (default: build csrc/)")
    ap.add_argument("--px", action="append", default=[], metavar="NAME=N",
                    help="pixels per thread of the kernels whose name holds NAME")
    args = ap.parse_args(argv)
    px = dict(PX_PER_THREAD)
    for item in args.px:
        key, val = item.split("=")
        px[key] = int(val)
    lib = args.lib
    if lib is None:
        from orbslam3_tpu_torch import _build

        _build.kernels()
        lib = str(_build.library_path())
    rows = counts(lib, px)
    for r in rows:
        per = "" if r["per_px"] is None else f", {r['per_px']:.1f} per pixel"
        top = " ".join(f"{op}:{c}" for op, c in r["top"])
        print(f"{r['kernel']}: {r['instructions']} SASS instructions{per}; {top}")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
