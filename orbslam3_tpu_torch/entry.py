"""Entry hook: the port's counterpart of the reference's
``__graft_entry__.entry()``.

The flagship "model" is the stereo perception front-end (pyramid, FAST,
selection, orientation, rBRIEF, left-right stereo matching).  `entry()`
returns it as one callable on one card with an example pair there.  The
reference's multi-chip dry run (`dryrun_multichip`) has no counterpart:
the port's target is one card.

    python -m orbslam3_tpu_torch.entry [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch._device import resolve_device


def _params(n_features=256):
    from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams

    return PyramidParams(n_features=n_features, n_levels=4)


def _make_pair(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (
        120 + 60 * np.sin(xx / 17.0) * np.cos(yy / 13.0) + rng.normal(0, 15, (h, w))
    ).clip(0, 255).astype(np.uint8)
    right = np.roll(img, -4, axis=1)
    return np.stack([img, right])


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): the stereo front-end's forward step on `device`
    (both cameras' features and the left-right match of a (2, H, W) uint8
    pair) and a 120x160 example pair there."""
    from orbslam3_tpu_torch.frontend import stereo_frame as sf

    dev = resolve_device(device)
    pair = torch.from_numpy(_make_pair(0, 120, 160)).to(dev)
    fe = sf.front_end(_params(), tuple(pair.shape[1:]), sf.DEFAULT_MBF, sf.DEFAULT_FX, str(dev))

    def fn(pair):
        return fe.features(pair)

    return fn, (pair,)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="run the entry hook's step once")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    fn, args = entry(a.device)
    out = fn(*args)
    n_left = int(out.left.valid.sum())
    n_matched = int((out.u_right >= 0).sum())
    print(f"entry step on {args[0].device}: {n_left} left keypoints of "
          f"{out.left.max_keypoints}, {n_matched} matched")
