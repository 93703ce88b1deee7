"""Device time of the stereo front-end by op, by category and by source.

The port's counterpart of the reference's `tools/trace_ops.py` with
`tools/attribute_trace.py` folded in.  One torch.profiler trace of the
stereo front-end's eager program (`StereoFrontEnd.eager`, op by op) over
`--frames` pairs of `bench.make_frame` prints the device time per op
(kernel name) and per category, the top N; each kernel is attributed to
the port's source file and function that launched it (the innermost
call of this package around the op, recorded as a profiler range for
each call, `package_ranges`): the counterpart of the reference's HLO
source metadata.
A second trace of the graphed frame (`StereoFrontEnd.forward`, one CUDA
graph replay) gives each kernel's device time and the idle time before
it inside the replay, with the source of the eager kernel it aligns
with: which of the graphed frame's ~2000 small ops leave the card idle.

With --device=cpu there is no device event: each op's time is its host
self time and the graphed frame is left out (a CPU frame runs op by op).

Usage: python -m orbslam3_tpu_torch.tools.trace_ops [top_n] [--frames=N]
           [--device=cpu]
"""

from __future__ import annotations

import contextlib
import difflib
import re
import sys

import numpy as np
import torch

H, W = 480, 752
PROFILE_TRIES = 6
# kernel name -> the port's CUDA source (kernels launched from ctypes)
CSRC = (
    ("fast_score_kernel", "csrc/fast_score.cu"), ("detect_select_kernel", "csrc/detect_fused.cu"),
    ("nms3_kernel", "csrc/detect_fused.cu"), ("gather_windows_kernel", "csrc/gather_windows.cu"),
    ("window_moments_kernel", "csrc/window_moments.cu"),
    ("sample_windows_kernel", "csrc/sample_windows.cu"), ("brief_kernel", "csrc/sample_windows.cu"),
    ("fast_variant_kernel", "csrc/fast_variants.cu"),
    ("grid_pool_coarse_kernel", "csrc/grid_pool.cu"), ("grid_pool_fine_kernel", "csrc/grid_pool.cu"),
    ("stereo_hamming_kernel", "csrc/stereo_hamming.cu"), ("sad_slots_kernel", "csrc/sad_refine.cu"),
    ("sad_median_kernel", "csrc/sad_refine.cu"),
)
CATS = (
    ("kernels (csrc)", tuple(k for k, _ in CSRC)),
    ("sort/top-k", ("sort", "radix", "topk", "bitonic", "segmented")),
    ("reduce/scan", ("reduce", "scan", "cumsum", "argmax", "argmin")),
    ("datamove", ("copy", "memcpy", "memset", "cat", "index", "gather", "scatter", "pad",
                  "fill", "where", "masked", "nonzero")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)
_FRAME = re.compile(r"(orbslam3_tpu_torch/[\w/]+\.py)\((\d+)\): (\S+)")


def categorize(name: str) -> str:
    low = name.lower()
    for cat, keys in CATS:
        if any(k in low for k in keys):
            return cat
    return "other"


def _frame_of(text: str) -> str | None:
    """'file.py:function' of a profiler frame of this package, else None."""
    m = _FRAME.search(text)
    return f"{m.group(1).split('orbslam3_tpu_torch/', 1)[1]}:{m.group(3)}" if m else None


def _source(event) -> str | None:
    """'file.py:function' of the innermost call of this package above an
    event in the profiler's event tree (`package_ranges`)."""
    node = event.cpu_parent
    while node is not None:
        if _frame_of(node.name):
            return _frame_of(node.name)
        node = node.cpu_parent
    return None


@contextlib.contextmanager
def package_ranges():
    """A profiler range around every call of a function of this package on
    this thread, named as the profiler names a Python frame
    ("orbslam3_tpu_torch/ops/fast.py(102): nms3"): the ops each call runs
    become its children in the event tree.  (The profiler's own
    ``with_stack`` records no Python frame on some CUDA builds.)"""
    from torch.autograd.profiler import record_function

    open_ranges = []

    def hook(frame, event, _arg):
        if event == "call":
            path = frame.f_code.co_filename
            if "orbslam3_tpu_torch" in path and not path.endswith("trace_ops.py"):
                rel = "orbslam3_tpu_torch" + path.split("orbslam3_tpu_torch", 1)[1]
                rf = record_function(f"{rel}({frame.f_code.co_firstlineno}): "
                                     f"{frame.f_code.co_name}")
                rf.__enter__()
                open_ranges.append((frame, rf))
        elif event == "return" and open_ranges and open_ranges[-1][0] is frame:
            open_ranges.pop()[1].__exit__(None, None, None)

    sys.setprofile(hook)
    try:
        yield
    finally:
        sys.setprofile(None)
        while open_ranges:
            open_ranges.pop()[1].__exit__(None, None, None)


def trace(fn, n: int, device: torch.device, sources: bool):
    """The profiler's events of fn(0), ..., fn(n - 1), with `package_ranges`
    if `sources`; on CUDA a session whose trace holds no device event is
    run again (up to PROFILE_TRIES times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    for _ in range(PROFILE_TRIES):
        with profile(activities=activities) as prof:
            with package_ranges() if sources else contextlib.nullcontext():
                for i in range(n):
                    fn(i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        events = prof.events()
        if device.type == "cpu" or any(e.device_type == DeviceType.CUDA for e in events):
            return events
    raise RuntimeError("the profiler's traces held no device event")


def eager_ops(events, device: torch.device) -> tuple[list, dict]:
    """([(op, us, source)] in launch order, {op: us}): on CUDA each kernel
    with the source of the op that launched it, on the CPU each aten op's
    self time."""
    from torch.autograd import DeviceType

    seq = []
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    for e in sorted(cpu, key=lambda e: e.time_range.start):
        if device.type == "cuda":
            # the package's ranges show on the device too, spanning kernels
            kernels = [k for k in getattr(e, "kernels", ()) if not _frame_of(k.name)]
            src = _source(e) if kernels else None
            for k in kernels:
                seq.append((k.name, float(k.duration), src or _kernel_source(k.name)))
        elif e.name.startswith("aten::") and e.self_cpu_time_total > 0:
            seq.append((e.name, float(e.self_cpu_time_total), _source(e) or "<no source>"))
    per_op: dict = {}
    if device.type == "cuda":  # every device event, linked to an op or not
        for e in events:
            if e.device_type == DeviceType.CUDA and not _frame_of(e.name):
                per_op[e.name] = per_op.get(e.name, 0.0) + float(e.time_range.elapsed_us())
    else:
        for name, us, _ in seq:
            per_op[name] = per_op.get(name, 0.0) + us
    return seq, per_op


def graphed_frames(events, n: int) -> list:
    """[[(kernel, start us, end us)] of each replay]: the device events in
    start order, cut into n replays of equal length."""
    from torch.autograd import DeviceType

    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == DeviceType.CUDA)
    per = len(dev) // n
    if per == 0 or per * n != len(dev):
        raise RuntimeError(f"{len(dev)} device events do not split into {n} equal replays")
    return [[(name, s, e) for s, e, name in dev[i * per:(i + 1) * per]] for i in range(n)]


def run(top_n: int = 40, frames: int = 8, device: str = "cuda", h: int = H, w: int = W) -> dict:
    """Trace, print the tables and return them."""
    from orbslam3_tpu_torch.bench import make_frame
    from orbslam3_tpu_torch.frontend.stereo_frame import DEFAULT_FX, DEFAULT_MBF, front_end
    from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams

    dev = torch.device(device)
    fe = front_end(PyramidParams(n_features=1000), (h, w), DEFAULT_MBF, DEFAULT_FX, str(dev))
    pairs = torch.from_numpy(np.stack([
        np.stack([make_frame(2 * i, h, w), make_frame(2 * i + 1, h, w)]) for i in range(frames)
    ])).to(dev)
    fe.eager(pairs[0])  # kernels built, caches warm
    unit = "device" if dev.type == "cuda" else "host self"
    seq, per_op = eager_ops(trace(lambda i: fe.eager(pairs[i]), frames, dev, True), dev)
    total = sum(per_op.values())
    print(f"eager: {unit} us over {frames} frames: {total:.0f} ({total / frames:.1f} a frame), "
          f"{sum(1 for _ in seq) / frames:.0f} ops a frame")
    cats: dict = {}
    for name, us in per_op.items():
        cats[categorize(name)] = cats.get(categorize(name), 0.0) + us
    for cat, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:16s} {us:10.0f} us  {100 * us / max(total, 1e-9):5.1f}%")
    print(f"\ntop {top_n} ops:")
    for name, us in sorted(per_op.items(), key=lambda kv: -kv[1])[:top_n]:
        print(f"  {us:9.1f} us  {name[:130]}")
    per_src: dict = {}
    for name, us, src in seq:
        per_src.setdefault(src, []).append((us, name))
    print(f"\nper source (file:function) {unit} us (n={frames} frames; us/frame in parens):")
    for src, items in sorted(per_src.items(), key=lambda kv: -sum(u for u, _ in kv[1]))[:top_n]:
        us = sum(u for u, _ in items)
        print(f"  {src:52s} {us:9.0f} us  ({us / frames:7.1f}/frame)")
        ops: dict = {}
        for u, name in items:
            ops[name] = ops.get(name, 0.0) + u
        for name, u in sorted(ops.items(), key=lambda kv: -kv[1])[:5]:
            print(f"      {u:8.1f}  {name[:80]}")
    result = dict(per_op=per_op, per_source={s: sum(u for u, _ in v) for s, v in per_src.items()},
                  categories=cats, frames=frames)
    if dev.type != "cuda":
        print("\ngraphed frame: none on the CPU (a CPU frame runs its program op by op)")
        return result
    result["graphed"] = graphed(fe, pairs, frames, seq, top_n)
    return result


def graphed(fe, pairs, frames: int, eager_seq: list, top_n: int) -> dict:
    """Per kernel of the graphed frame: device us and the idle us before it
    inside the replay, a frame; sources from the aligned eager kernels."""
    fe(pairs[0])  # the capture
    torch.cuda.synchronize()

    def one(i):
        fe(pairs[i])
        torch.cuda.synchronize()  # the replays apart: each one's gaps are its own

    # a trace late in a long process can miss device events: take a
    # session whose replays each hold every eager kernel at least (the
    # graph adds the input copy and the output clone)
    eager_one = eager_seq[: len(eager_seq) // frames]
    for _ in range(PROFILE_TRIES):
        try:
            replays = graphed_frames(trace(one, frames, pairs.device, False), frames)
        except RuntimeError:
            continue
        if len(replays[0]) >= len(eager_one):
            break
    else:
        raise RuntimeError(f"no graphed trace of {PROFILE_TRIES} held every kernel of the frame")
    k_per = len(replays[0])
    match = difflib.SequenceMatcher(None, [n for n, _, _ in eager_one],
                                     [n for n, _, _ in replays[0]], autojunk=False)
    src_of = ["<graph only>"] * k_per
    for a, b, size in match.get_matching_blocks():
        for j in range(size):
            src_of[b + j] = eager_one[a + j][2]
    rows: dict = {}
    window = busy = largest = 0.0
    at: dict = {}  # (position, op) of each replay's largest gap -> replays
    for rep in replays:
        window += rep[-1][2] - rep[0][1]
        prev_end = rep[0][1]
        gap_max = (0.0, 0, "")
        for j, (name, s, e) in enumerate(rep):
            key = (name, src_of[j])
            r = rows.setdefault(key, [0, 0.0, 0.0])
            gap = max(0.0, s - prev_end)
            r[0] += 1
            r[1] += e - s
            r[2] += gap
            busy += e - s
            prev_end = max(prev_end, e)
            gap_max = max(gap_max, (gap, j, name))
        largest += gap_max[0]
        at[gap_max[1:]] = at.get(gap_max[1:], 0) + 1
    n = frames
    idle = window - busy
    (j, name), _ = max(at.items(), key=lambda kv: kv[1])
    print(f"\ngraphed frame (one replay of StereoFrontEnd.forward's graph, {k_per} device ops): "
          f"window {window / n:.1f} us, busy {busy / n:.1f} us ({100 * busy / window:.1f} %), "
          f"idle {idle / n:.1f} us a frame")
    print(f"  of the idle: the largest gap of each replay {largest / n:.1f} us (before op "
          f"{j + 1} of {k_per}, {name[:60]}), the other {k_per - 2} gaps "
          f"{(idle - largest) / n:.1f} us")
    print(f"top {top_n} kernels of the graphed frame by device us a frame "
          "(calls, device us, idle us before them; source of the aligned eager kernel):")
    for (name, src), (c, d, idle) in sorted(rows.items(), key=lambda kv: -kv[1][1])[:top_n]:
        print(f"  {d / n:8.1f} {idle / n:8.1f}  x{c // n:<4d} {src:44s} {name[:70]}")
    print(f"top {top_n} kernels of the graphed frame by idle us before them a frame:")
    for (name, src), (c, d, idle) in sorted(rows.items(), key=lambda kv: -kv[1][2])[:top_n]:
        print(f"  {idle / n:8.1f} {d / n:8.1f}  x{c // n:<4d} {src:44s} {name[:70]}")
    idle_src: dict = {}
    for (name, src), (c, d, idle) in rows.items():
        s = idle_src.setdefault(src, [0, 0.0, 0.0])
        s[0] += c
        s[1] += d
        s[2] += idle
    print("per source, graphed (idle us, device us, ops a frame):")
    for src, (c, d, idle) in sorted(idle_src.items(), key=lambda kv: -kv[1][2])[:top_n]:
        print(f"  {idle / n:8.1f} {d / n:8.1f}  x{c // n:<5d} {src}")
    return dict(window_us=window / n, busy_us=busy / n, ops=k_per, largest_gap_us=largest / n,
                kernels={f"{name} @ {src}": (c / n, d / n, idle / n)
                         for (name, src), (c, d, idle) in rows.items()})


def main(argv=None) -> int:
    from orbslam3_tpu_torch.tools.card import open_device

    argv = sys.argv[1:] if argv is None else argv
    device = next((a.split("=", 1)[1] for a in argv if a.startswith("--device=")), "cuda")
    frames = int(next((a.split("=", 1)[1] for a in argv if a.startswith("--frames=")), 8))
    pos = [a for a in argv if not a.startswith("--")]
    if open_device("trace_ops", device) is None:
        return 1
    run(int(pos[0]) if pos else 40, frames, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
