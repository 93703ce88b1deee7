"""Textured planes rendered into a rectified stereo rig, on the card.

A torch rewrite of the port's `utils/synth.render_world` and
`make_texture` (nearest-hit ray casting against textured planes,
bilinear texture sampling; aperiodic textures of smooth noise, fine
noise and random polygons), so that a lap of frames is made on the
device in a few large calls at set-up.  Ground truth is exact: each
frame is rendered at the pose the lap gives it.
"""

from __future__ import annotations

import math

import torch

SKY = 127.0  # grey where no plane is hit, as render_world


class Plane:
    """A textured plane: texture pixel (u, v) lies at p0 + scale * (u ex + v ey)."""

    def __init__(self, texture: torch.Tensor, p0, ex, ey, scale: float):
        dev = texture.device
        f64 = dict(dtype=torch.float64, device=dev)
        self.tex = texture.to(torch.float32)
        self.p0 = torch.as_tensor(p0, **f64)
        self.ex = torch.as_tensor(ex, **f64)
        self.ey = torch.as_tensor(ey, **f64)
        self.scale = float(scale)
        n = torch.linalg.cross(self.ex, self.ey)
        self.n = n / torch.linalg.norm(n)


def _smooth_noise(h: int, w: int, coarse: int, gen: torch.Generator) -> torch.Tensor:
    """Bilinear upsampling of a coarse normal grid (coarse cells along the
    longer side)."""
    ch = max(2, round(coarse * h / max(h, w)))
    cw = max(2, round(coarse * w / max(h, w)))
    g = torch.randn((1, 1, ch, cw), generator=gen, device=gen.device, dtype=torch.float32)
    return torch.nn.functional.interpolate(g, size=(h, w), mode="bilinear", align_corners=True)[0, 0]


def make_texture(h: int, w: int, gen: torch.Generator, noise_cells=(48, 192),
                 blobs: int | None = None, chunk: int = 4096) -> torch.Tensor:
    """(h, w) uint8 aperiodic texture: two layers of smooth noise (with
    `noise_cells` cells along the longer side), fine noise, and `blobs`
    (by default round(sqrt(h w))) filled random polygons of 3-6 vertices
    (radius 2.5-11 px), the later over the earlier.  No periodic component:
    a repeating pattern makes descriptors alike across its period."""
    dev = gen.device
    img = (
        120.0 + 55.0 * _smooth_noise(h, w, noise_cells[0], gen)
        + 30.0 * _smooth_noise(h, w, noise_cells[1], gen)
        + 8.0 * torch.randn((h, w), generator=gen, device=dev)
    )
    img = img.clamp(0, 255).to(torch.uint8)
    n = round(math.sqrt(h * w)) if blobs is None else int(blobs)

    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)

    cx = torch.floor(uniform(n, lo=12, hi=w - 12))
    cy = torch.floor(uniform(n, lo=12, hi=h - 12))
    n_v = torch.randint(3, 7, (n,), generator=gen, device=dev)
    radius = uniform(n, lo=2.5, hi=11.0)
    stretch = uniform(n, lo=0.4, hi=1.6)
    angles = torch.sort(uniform(n, 6, hi=2 * math.pi), dim=1).values
    value = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.int32)
    # slots past a polygon's n_v repeat its last vertex: zero-length edges
    slot = torch.arange(6, device=dev)[None, :]
    angles = angles.gather(1, torch.minimum(slot, n_v[:, None] - 1))
    vx = cx[:, None] + radius[:, None] * torch.cos(angles)
    vy = cy[:, None] + (radius * stretch)[:, None] * torch.sin(angles)
    half = math.ceil(11.0 * 1.6) + 1
    off = torch.arange(-half, half + 1, device=dev, dtype=torch.float64)
    owner = torch.full((h * w,), -1, dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        sl = slice(s, min(n, s + chunk))
        px = (cx[sl, None, None] + off[None, None, :]).expand(-1, off.numel(), -1)
        py = (cy[sl, None, None] + off[None, :, None]).expand(-1, -1, off.numel())
        inside = torch.zeros(px.shape, dtype=torch.bool, device=dev)
        x0, y0 = vx[sl], vy[sl]
        x1, y1 = x0.roll(-1, 1), y0.roll(-1, 1)
        for j in range(6):  # even-odd crossing test of each pixel centre
            xa, ya = x0[:, j, None, None], y0[:, j, None, None]
            xb, yb = x1[:, j, None, None], y1[:, j, None, None]
            crosses = (ya > py) != (yb > py)
            x_at = xa + (py - ya) * (xb - xa) / torch.where(yb == ya, 1.0, yb - ya)
            inside ^= crosses & (px < x_at)
        ok = inside & (px >= 0) & (px < w) & (py >= 0) & (py < h)
        idx = (py * w + px).to(torch.int64)[ok]
        poly = torch.arange(sl.start, sl.stop, device=dev)[:, None, None].expand(px.shape)[ok]
        owner.scatter_reduce_(0, idx, poly, reduce="amax")
    drawn = owner >= 0
    flat = img.reshape(-1)
    flat[drawn] = value[owner[drawn]].to(torch.uint8)
    return img


def render(planes: list, intrinsics, R_wc: torch.Tensor, c_w: torch.Tensor, h: int, w: int
           ) -> torch.Tensor:
    """(B, h, w) uint8 images of the planes seen by B pinhole cameras with
    rotations R_wc (B, 3, 3) and centres c_w (B, 3) in the world (float64),
    intrinsics (fx, fy, cx, cy): each pixel takes the nearest plane hit,
    sampled bilinearly, and SKY where it hits none."""
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    dev = R_wc.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                            torch.arange(w, dtype=torch.float64, device=dev), indexing="ij")
    rays_c = torch.stack([(xs.reshape(-1) - cx) / fx, (ys.reshape(-1) - cy) / fy,
                          torch.ones(h * w, dtype=torch.float64, device=dev)], dim=1)
    rays = torch.einsum("pk,bjk->bpj", rays_c, R_wc)  # (B, hw, 3)
    best_t = torch.full(rays.shape[:2], math.inf, dtype=torch.float64, device=dev)
    best_v = torch.full(rays.shape[:2], SKY, dtype=torch.float32, device=dev)
    for pl in planes:
        denom = rays @ pl.n
        t = ((pl.p0 - c_w) @ pl.n)[:, None] / torch.where(denom.abs() < 1e-9, 1e-9, denom)
        rel = c_w[:, None, :] + rays * t[..., None] - pl.p0
        u = (rel @ pl.ex) / pl.scale
        v = (rel @ pl.ey) / pl.scale
        th, tw = pl.tex.shape
        inside = (u >= 0) & (u < tw - 1) & (v >= 0) & (v < th - 1) & (t > 0.05)
        u = u.clamp(0, tw - 1.001)
        v = v.clamp(0, th - 1.001)
        u0 = u.to(torch.int64)
        v0 = v.to(torch.int64)
        fu = (u - u0).to(torch.float32)
        fv = (v - v0).to(torch.float32)
        tex = pl.tex.reshape(-1)
        i00 = v0 * tw + u0
        val = (
            tex[i00] * (1 - fu) * (1 - fv)
            + tex[i00 + 1] * fu * (1 - fv)
            + tex[i00 + tw] * (1 - fu) * fv
            + tex[i00 + tw + 1] * fu * fv
        )
        take = inside & (t < best_t)
        best_t = torch.where(take, t, best_t)
        best_v = torch.where(take, val, best_v)
    return best_v.clamp(0, 255).to(torch.uint8).reshape(-1, h, w)
