"""One frame's device program as a CUDA graph: captured once, replayed for
every frame.

The reference runs each frame's front-end as one `jax.jit` dispatch
(`extract_and_match_stereo_packed`, `extract_features_jit`).  Run op by
op from Python, the port's program is some 900-2000 separate device ops a
frame, and the card waits on the host between them.  `FrameGraph` holds
one program `fn(static_input) -> tensor` on one CUDA device, with its
static input buffer, the captured `torch.cuda.CUDAGraph` and the graph's
static output:

- the first call copies the input into the static buffer, runs `fn`
  eagerly on a side stream (its output is this call's result; the run
  also builds the kernels before any capture), then captures `fn` under
  `torch.cuda.graph`;
- every later call copies the input into the static buffer, replays the
  graph and clones the static output (or copies it into `out`), all on
  the caller's current stream.

A replay runs the same kernels and torch ops in the same order as the
eager program, so its output is the eager program's bit for bit.  There
is no fallback: a program that cannot be captured (a host synchronisation
inside it) raises at the first call, and no call runs it eagerly in place
of the graph.  The CPU is refused: a caller that asked for the CPU runs
the program itself.

Launch counts: the kernel wrappers count in Python, which a replay does
not run.  The capture records what it added to each count
(`utils.launches`), takes it back, since the capture launched nothing on
the card, and every replay adds it again.

Streams: two streams may replay one graph (`System.prefetch_stereo` on
its side stream, `track_stereo` on the current one).  Each call records
an event after its outputs are cloned, and the next call's stream waits
on it before it writes the static input, so no replay overwrites a
static buffer that an earlier call still reads.  A lock keeps two threads
from interleaving their calls.

Captures use `capture_error_mode="thread_local"`: an unsafe CUDA call
made by the capturing thread fails the capture, while the System's host
threads (LocalMapping, LoopClosing, the global BA), which make no CUDA
call, are neither stopped nor able to invalidate it.

The module buffers `fn` reads are baked into the graph by address, so a
module that is moved or cast drops its graphs (`TableModule._apply`).
`trace_range` / NVTX ranges inside `fn` run at the capture only.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from orbslam3_tpu_torch.utils import launches

CAPTURE_ERROR_MODE = "thread_local"


class FrameGraph:
    """The CUDA graph of one frame program on one CUDA device."""

    def __init__(self, fn, device: str | torch.device):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(
                f"FrameGraph captures a program on a CUDA device, not on {dev}; "
                "on the CPU call the program itself"
            )
        self.fn = fn
        self.device = torch.device("cuda", torch.cuda.current_device()) if dev.index is None else dev
        self.graph: torch.cuda.CUDAGraph | None = None
        self.static_in: torch.Tensor | None = None
        self.static_out: torch.Tensor | None = None
        self.launches: dict[str, int] = {}  # kernel launches of one replay
        self.warmup_ms: float | None = None  # host wall of the first call's eager run
        self.capture_ms: float | None = None  # host wall of the capture
        self.pool_bytes: int | None = None  # device memory the graph's private pool reserved
        self.replays = 0
        self._lock = threading.Lock()
        self._free: torch.cuda.Event | None = None

    def __call__(self, x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        """fn(x): the eager run at the first call, a replay after it.  With
        `out` the result is copied there and `out` returned; otherwise a
        fresh tensor is returned."""
        if x.device != self.device:
            raise ValueError(f"input on {x.device}, frame graph on {self.device}")
        with self._lock:
            stream = torch.cuda.current_stream(self.device)
            if self._free is not None:
                stream.wait_event(self._free)  # the last call has read the static buffers
            if self.graph is None:
                result = self._first_call(x, stream)
                delivered = result if out is None else out.copy_(result)
            else:
                if x.shape != self.static_in.shape or x.dtype != self.static_in.dtype:
                    raise ValueError(
                        f"input {x.dtype} {tuple(x.shape)}, graph captured for "
                        f"{self.static_in.dtype} {tuple(self.static_in.shape)}"
                    )
                self.static_in.copy_(x)
                self.graph.replay()
                launches.add(self.launches)
                self.replays += 1
                delivered = self.static_out.clone() if out is None else out.copy_(self.static_out)
            self._free = torch.cuda.Event()
            self._free.record(stream)
            return delivered

    def _first_call(self, x: torch.Tensor, stream: torch.cuda.Stream) -> torch.Tensor:
        """The eager run on a side stream (this call's result), then the
        capture."""
        dev = x.device
        self.static_in = torch.empty_like(x, memory_format=torch.contiguous_format)
        self.static_in.copy_(x)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            result = self.fn(self.static_in)
        stream.wait_stream(side)
        result.record_stream(stream)  # made on the side stream, read on this one
        self.warmup_ms = (time.perf_counter() - t0) * 1e3

        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with launches.recorded() as per_replay, torch.cuda.device(dev), torch.cuda.graph(
                graph, capture_error_mode=CAPTURE_ERROR_MODE
            ):
                # entering the capture emptied the allocator's cache: what
                # the memory reserved grows by from here is the graph's pool
                reserved = torch.cuda.memory_reserved(dev)
                static_out = self.fn(self.static_in)
        finally:
            # a capture that fails raises out of `torch.cuda.graph`'s exit
            # before it gives the caller's stream back
            torch.cuda.set_stream(stream)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = per_replay
        self.static_out = static_out
        self.graph = graph
        return result


class TableModule(torch.nn.Module):
    """Constant tables (an extractor's taps and masks, a rectifier's maps),
    held as module buffers so `.to(device)` moves them all, and the CUDA
    graphs of the module's frame programs (`replay`), captured at their
    first CUDA call.  A graph reads
    the buffers at the addresses they had at its capture, so moving or
    casting the module drops its graphs; the next CUDA call captures anew."""

    def __init__(self, tables: dict[str, np.ndarray]):
        super().__init__()
        for name, arr in tables.items():
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(arr)))
        self.graphs: dict[str, FrameGraph] = {}

    def _apply(self, fn, *args, **kwargs):
        # `.to()`, `.cuda()`, `.half()` ... reallocate the buffers
        out = super()._apply(fn, *args, **kwargs)
        self.graphs = {}
        return out

    def replay(self, name: str, program, x: torch.Tensor, out: torch.Tensor | None = None):
        """program(x) (into `out` if given): on a CUDA tensor the replay of
        the module's graph `name`, captured from `program` at its first
        call; on a CPU tensor, where the caller asked for the CPU, the
        program itself."""
        if x.device.type == "cpu":
            result = program(x)
            return result if out is None else out.copy_(result)
        graph = self.graphs.get(name)
        if graph is None:
            graph = self.graphs.setdefault(name, FrameGraph(program, x.device))
        return graph(x, out)
