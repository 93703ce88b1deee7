"""User-facing demo: ORB feature extraction on the card.

Usage: python -m orbslam3_tpu_torch.examples.demo_extract
           [--device cuda|cpu] [--fused detect,moments,sample]

The mono extractor (`FeatureExtractor`) on one 752x480 frame, then both
cameras of a stereo pair through `StereoFrontEnd.extract` and the lapping
split.  Nothing is compiled ahead: the CUDA kernels build at their first
launch (seconds), and each later call runs eagerly.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from orbslam3_tpu_torch._device import resolve_device
from orbslam3_tpu_torch.ops.extractor import FusedKernels, feature_extractor, split_lapping
from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams


def make_frame(seed: int, h: int = 480, w: int = 752) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (120 + 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0) + rng.normal(0, 18, (h, w))).clip(0, 255)
    for _ in range(120):
        cx, cy = int(rng.integers(20, w - 20)), int(rng.integers(20, h - 20))
        r = int(rng.integers(3, 14))
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = int(rng.integers(0, 256))
    return img.astype(np.uint8)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(device: str = "cuda", fused: FusedKernels = FusedKernels()):
    from orbslam3_tpu_torch.frontend.stereo_frame import front_end

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name}), torch {torch.__version__}")
    params = PyramidParams(n_features=1000)
    img = torch.from_numpy(make_frame(0)).to(dev)
    fe = feature_extractor(params, tuple(img.shape), fused, str(dev))

    t0 = time.perf_counter()
    feat = fe(img)
    _sync(dev)
    print(f"mono: first call (tables + kernel build + run) {time.perf_counter() - t0:.2f}s")
    for _ in range(3):
        img2 = torch.from_numpy(make_frame(1)).to(dev)
        t0 = time.perf_counter()
        feat = fe(img2)
        _sync(dev)
        print(f"mono steady-state: {(time.perf_counter() - t0) * 1e3:.2f} ms")

    valid = feat.valid.cpu().numpy()
    print(f"keypoints: {int(valid.sum())}/{feat.max_keypoints} valid")
    oct_counts = np.bincount(feat.octave.cpu().numpy()[valid], minlength=8)
    print("per-octave:", oct_counts.tolist())
    print("sample kp:", feat.xy.cpu().numpy()[valid][:3].tolist())
    print("sample desc bytes:", feat.desc.cpu().numpy()[valid][0][:8].tolist())

    # both cameras of a stereo pair + lapping split
    pair = torch.from_numpy(np.stack([make_frame(2), make_frame(3)])).to(dev)
    sfe = front_end(params, tuple(pair.shape[1:]), 47.9, 435.2, str(dev), fused)
    t0 = time.perf_counter()
    left, _right = sfe.extract(pair)
    _sync(dev)
    print(f"stereo pair (tables + run): {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    left, _right = sfe.extract(pair)
    _sync(dev)
    print(f"stereo steady-state: {(time.perf_counter() - t0) * 1e3:.2f} ms")
    left_np = {k: v.cpu().numpy() for k, v in left._asdict().items()}
    order, mono_idx = split_lapping(left_np, (100.0, 400.0))
    print(f"lapping split: {len(order)} valid, mono_index={mono_idx}")
    return feat, left


if __name__ == "__main__":
    import argparse

    from orbslam3_tpu_torch.examples.common import add_device_options, parse_fused

    ap = argparse.ArgumentParser(description="ORB extraction demo")
    add_device_options(ap)
    a = ap.parse_args()
    main(a.device, parse_fused(a.fused))
