"""Rectified pinhole stereo: frames rendered already rectified from the
configuration's `Rectified.*` pinhole and baseline, handed to
`System.track_stereo` with no IMU; the plain reference is the rectified
stereo front-end on the flat geometry (`reference/frontend.py`)."""

from __future__ import annotations

import importlib

import numpy as np
import torch

from slambench import work
from slambench.harness import Lap, reference_block
from slambench.reference.frontend import OrbParams, StereoReference
from slambench.world.render import Plane, make_texture, render

RENDER_BATCH = 16
FIELDS = ("kps", "octave", "angle", "response", "desc", "u_right", "depth")


def render_lap(cfg: dict, seed: int, device) -> Lap:
    """Textures from `seed` with a generator on `device`, then the lap's
    stereo pairs rendered there in batches and copied to the host."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    planes = [Plane(make_texture(*p["texture"], gen, p.get("noise_cells", (48, 192)),
                                 p.get("blobs")), p["p0"], p["ex"], p["ey"], p["scale"])
              for p in cfg["world"]["planes"]]
    seq = cfg["sequence"]
    kind = importlib.import_module(f"slambench.world.laps.{seq['kind']}")
    R_wc, c_w = kind.poses(seq, np.arange(seq["frames"]))
    h, w = cfg["Camera.height"], cfg["Camera.width"]
    intr = intrinsics(cfg)
    base = np.array([baseline(cfg), 0.0, 0.0])
    images = np.empty((len(R_wc), 2, h, w), np.uint8)
    with torch.no_grad():
        for s in range(0, len(R_wc), RENDER_BATCH):
            R = torch.from_numpy(R_wc[s : s + RENDER_BATCH]).to(device)
            c = torch.from_numpy(c_w[s : s + RENDER_BATCH]).to(device)
            right = c + R @ torch.from_numpy(base).to(device)  # the right camera's centre
            pair = torch.stack([render(planes, intr, R, c, h, w),
                                render(planes, intr, R, right, h, w)], dim=1)
            images[s : s + RENDER_BATCH] = pair.cpu().numpy()
    return Lap(images, R_wc, c_w)


def intrinsics(cfg: dict) -> tuple:
    """(fx, fy, cx, cy) of the rectified left camera, which the frames are rendered in."""
    return tuple(cfg[f"Rectified.{k}"] for k in ("fx", "fy", "cx", "cy"))


def baseline(cfg: dict) -> float:
    """The rectified pair's baseline in metres, bf / fx."""
    return cfg["Rectified.bf"] / cfg["Rectified.fx"]


def orb_params(cfg: dict) -> OrbParams:
    return OrbParams(cfg["ORBextractor.nFeatures"], cfg["ORBextractor.scaleFactor"],
                     cfg["ORBextractor.nLevels"], cfg["ORBextractor.iniThFAST"],
                     cfg["ORBextractor.minThFAST"])


def reference_of(cfg: dict, device, float_dtype=torch.float32) -> StereoReference:
    return StereoReference(orb_params(cfg), (cfg["Camera.height"], cfg["Camera.width"]),
                           cfg["Rectified.bf"], cfg["Rectified.fx"], device, float_dtype)


def training_descriptors(cfg: dict, lap: Lap, ks, device) -> np.ndarray:
    """The plain reference's descriptors of the left images of lap frames `ks`."""
    ref = reference_of(cfg, device)
    descs = []
    for k in ks:
        block = reference_block(ref, lap, k)
        descs.append(block[block[:, 5] > 0.5, 8:40].astype(np.uint8))
    return np.concatenate(descs)


def make_system(cfg: dict, vocabulary, device):
    """The threaded System as `System.from_files` makes it from the settings."""
    from orbslam3_tpu_torch.cameras.models import Pinhole
    from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams
    from orbslam3_tpu_torch.slam.system import System

    camera = Pinhole(list(intrinsics(cfg)))
    params = PyramidParams(
        n_features=cfg["ORBextractor.nFeatures"], scale_factor=cfg["ORBextractor.scaleFactor"],
        n_levels=cfg["ORBextractor.nLevels"], ini_th_fast=cfg["ORBextractor.iniThFAST"],
        min_th_fast=cfg["ORBextractor.minThFAST"])
    system = System(camera, cfg["Rectified.bf"], params, sequential=False,
                    vocabulary=vocabulary, max_frames=int(cfg["Camera.fps"]), device=device)
    system.tracker.depth_th = baseline(cfg) * cfg["Stereo.ThDepth"]
    return system


def track(system, lap: Lap, k: int, timestamp: float):
    left, right = lap.views(k)
    return system.track_stereo(left, right, timestamp)


def unpack(block: np.ndarray) -> dict:
    """The valid rows of a packed (K, 40) block as the tracker's frame holds
    them (`FIELDS`)."""
    a = block[block[:, 5] > 0.5]
    return dict(kps=a[:, 0:2], response=a[:, 2], angle=a[:, 3], octave=a[:, 4].astype(np.int32),
                u_right=a[:, 6], depth=a[:, 7], desc=a[:, 8:40].astype(np.uint8))


def features_differ(ref_block: np.ndarray, got: dict) -> int:
    """Features that differ between the reference's packed block and what
    the tracker read: every valid reference row against the program's
    feature of the same rank (keypoint, octave, angle, response,
    descriptor, right coordinate, depth), plus any surplus on either side."""
    a = ref_block[ref_block[:, 5] > 0.5]
    want = np.concatenate([a[:, [0, 1, 2, 3, 4, 6, 7]].astype(np.float64), a[:, 8:40]], axis=1)
    have = np.concatenate([
        got["kps"].astype(np.float64), got["response"][:, None], got["angle"][:, None],
        got["octave"][:, None], got["u_right"][:, None], got["depth"][:, None],
        got["desc"].astype(np.float64)], axis=1)
    n = min(len(want), len(have))
    return int((want[:n] != have[:n]).any(axis=1).sum()) + abs(len(want) - len(have))


def least_seconds(cfg: dict) -> float:
    return work.least_seconds(cfg["Camera.height"], cfg["Camera.width"],
                              cfg["ORBextractor.nFeatures"], cfg["ORBextractor.nLevels"],
                              cfg["ORBextractor.scaleFactor"])
