"""Named trace ranges for the port (the reference's NVTX PUSH/POP role).

The JAX package's `trace_range` opens a `jax.profiler.TraceAnnotation`;
the port's range is a `torch.profiler.record_function` (visible in a
torch.profiler trace), an NVTX range when the device is CUDA, and a
sample in the shared host `Benchmark` under the same tag.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from orbslam3_tpu.utils.benchmark import Benchmark

__all__ = ["Benchmark", "trace_range"]


@contextmanager
def trace_range(name: str, device: torch.device | None = None):
    """Named range in the profiler timeline, recorded in `Benchmark`."""
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
