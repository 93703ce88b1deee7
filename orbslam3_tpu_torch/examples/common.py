"""What the drivers share: the --device and --fused options, PNG reading
with its time recorded, and the timing summary they print."""

from __future__ import annotations

import argparse
import statistics

from orbslam3_tpu_torch.ops.extractor import FusedKernels
from orbslam3_tpu_torch.utils.benchmark import Benchmark
from orbslam3_tpu_torch.utils.imageio import imread

# host wall ms per image read, and per call of the System's entry point
DECODE_TAG = "0_LoadImage.decode"
TRACK_TAG = "0_Track.wall"
FUSED_NAMES = FusedKernels._fields  # ("detect", "moments", "sample")


def parse_fused(text: str | None) -> FusedKernels:
    """FusedKernels from "detect,moments,sample" (any subset, "" for none):
    the reference's ORBSLAM3_TPU_PALLAS_DETECT / _MOMENTS / _SAMPLE."""
    names = [n for n in (text or "").split(",") if n]
    unknown = sorted(set(names) - set(FUSED_NAMES))
    if unknown:
        raise ValueError(f"--fused takes {','.join(FUSED_NAMES)}, not {unknown}")
    return FusedKernels(*(n in names for n in FUSED_NAMES))


def add_device_options(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device of the front-end (default cuda; cpu on request)")
    ap.add_argument("--fused", default="",
                    help="fused kernels to run: any of detect,moments,sample (default none)")


def read_image(path: str, **kw):
    """utils.imageio.imread, its wall time recorded under DECODE_TAG."""
    with Benchmark.the().measure(DECODE_TAG):
        return imread(path, **kw)


def timing_summary() -> str:
    """Median ms of the image reads and entry-point calls recorded so far."""
    rec = Benchmark.the().records
    parts = [
        f"{label} median {statistics.median(rec[tag]):.2f} ms ({len(rec[tag])})"
        for label, tag in (("decode", DECODE_TAG), ("track", TRACK_TAG)) if rec.get(tag)
    ]
    return "; ".join(parts)
