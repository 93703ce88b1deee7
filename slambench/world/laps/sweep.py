"""An oscillating sweep through a room, closed after `frames` frames.

Each translation and rotation component is amp * sin(2 pi cycles k / frames)
with a whole number of cycles, so the lap closes; rotations are the
exponential map of the rotation vector (x right, y down, z forward)."""

from __future__ import annotations

import numpy as np


def _so3_exp(w: np.ndarray) -> np.ndarray:
    """(N, 3) rotation vectors -> (N, 3, 3) rotations (Rodrigues)."""
    th = np.linalg.norm(w, axis=1)
    safe = np.where(th < 1e-12, 1.0, th)
    k = w / safe[:, None]
    kx = np.zeros((len(w), 3, 3))
    kx[:, 0, 1], kx[:, 0, 2], kx[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    kx[:, 1, 0], kx[:, 2, 0], kx[:, 2, 1] = k[:, 2], -k[:, 1], k[:, 0]
    s, c = np.sin(th)[:, None, None], np.cos(th)[:, None, None]
    return np.eye(3)[None] + s * kx + (1 - c) * (kx @ kx)


def poses(lap: dict, k) -> tuple[np.ndarray, np.ndarray]:
    k = np.asarray(k, np.float64).reshape(-1)
    phase = 2 * np.pi * k[:, None] / lap["frames"]
    t = np.asarray(lap["t_amp"]) * np.sin(phase * np.asarray(lap["t_cycles"]))
    w = np.asarray(lap["rot_amp"]) * np.sin(phase * np.asarray(lap["rot_cycles"]))
    return _so3_exp(w), t
