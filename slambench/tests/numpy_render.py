"""A frozen numpy copy of the port's `utils/synth.PlaneWorld.intersect` and
`render_world` (pinhole without distortion), the yardstick the card's
renderer (`slambench.world.render`) is held to at a small size."""

from __future__ import annotations

import numpy as np


class PlaneWorld:
    def __init__(self, texture: np.ndarray, p0, ex, ey, scale: float):
        self.tex = texture.astype(np.float32)
        self.p0 = np.asarray(p0, np.float64)
        self.ex = np.asarray(ex, np.float64)
        self.ey = np.asarray(ey, np.float64)
        self.scale = scale
        self.n = np.cross(self.ex, self.ey)
        self.n /= np.linalg.norm(self.n)

    def intersect(self, c: np.ndarray, rays_w: np.ndarray):
        denom = rays_w @ self.n
        tplane = ((self.p0 - c) @ self.n) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        pts = c + rays_w * tplane[:, None]
        rel = pts - self.p0
        u = (rel @ self.ex) / self.scale
        v = (rel @ self.ey) / self.scale
        th, tw = self.tex.shape
        inside = (u >= 0) & (u < tw - 1) & (v >= 0) & (v < th - 1) & (tplane > 0.05)
        u = np.clip(u, 0, tw - 1.001)
        v = np.clip(v, 0, th - 1.001)
        u0 = u.astype(np.int64)
        v0 = v.astype(np.int64)
        fu = (u - u0).astype(np.float32)
        fv = (v - v0).astype(np.float32)
        t = self.tex
        val = (
            t[v0, u0] * (1 - fu) * (1 - fv)
            + t[v0, u0 + 1] * fu * (1 - fv)
            + t[v0 + 1, u0] * (1 - fu) * fv
            + t[v0 + 1, u0 + 1] * fu * fv
        )
        return tplane, val, inside


def render_world(planes: list, intrinsics, R_wc: np.ndarray, c: np.ndarray, h: int, w: int):
    fx, fy, cx, cy = intrinsics
    ys, xs = np.mgrid[0:h, 0:w]
    pix = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64)
    rays_c = np.stack([(pix[:, 0] - cx) / fx, (pix[:, 1] - cy) / fy, np.ones(len(pix))], axis=1)
    rays_w = rays_c @ R_wc.T
    best_t = np.full(len(rays_w), np.inf)
    best_v = np.full(len(rays_w), 127.0, np.float32)
    for pl in planes:
        t, v, ok = pl.intersect(c, rays_w)
        take = ok & (t < best_t)
        best_t = np.where(take, t, best_t)
        best_v = np.where(take, v, best_v)
    return np.clip(best_v.reshape(h, w), 0, 255).astype(np.uint8)
