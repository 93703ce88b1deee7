"""Plain reference of the stereo front-end the benchmark's cells time.

A frozen copy of the program's plain program for the rectified stereo
pair on the flat geometry (every pyramid level active at its full
quota, which both configurations have): the pyramid (cv2's INTER_LINEAR
8u resize), the fixed-point 7x7 blur, FAST-9/16 with the per-32x32-tile
two-threshold retry and strict 3x3 NMS over the shelf-packed detection
composite, the grid top-K selection, the intensity-centroid angle,
rBRIEF, and the left-right match (masked Hamming over the pair grid,
the 11-slide SAD subpixel refinement and the median-SAD filter).  Every
step is plain torch on the input's device, the hand-written kernels'
places taken by the torch ops they replaced, and every table is built
here from its numpy source.  It imports nothing of the program.

`StereoReference(...)(pair)` returns the (K, 40) f32 block in the
program's packed layout: x, y, response, angle, octave, valid, u_right,
depth, desc[32].  `float_dtype` computes the float stages (keypoint
scaling, the angle's atan2, the BRIEF rotation, the subpixel parabola
and the depth) in that type: torch.bfloat16 is the correctness
control, the nearest precision below the float32 the program states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slambench.reference.brief_pattern import BIT_PATTERN_31

PATCH_SIZE = 31
HALF_PATCH_SIZE = 15
EDGE_THRESHOLD = 19
FAST_BORDER = EDGE_THRESHOLD - 3
TILE = 32
COMPOSITE_BAND = 4
BRIEF_PAD = 19
PATCH_HALF = 18
BRIEF_WINDOW = 2 * PATCH_HALF + 1
IC_WINDOW = 2 * HALF_PATCH_SIZE + 1
BLUR_FRAC_BITS = 16
SAD_W = 5
SAD_L = 5
TH_LOW = 50
TH_HIGH = 100
BIG = 1 << 15
MEDIAN_FACTOR = 1.5 * 1.4
_FACTOR_PI = float(np.float32(math.pi / 180.0))

FAST_RING = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


# --- the numpy tables ------------------------------------------------------

def cv_round(x):
    """cvRound: round half to even."""
    return np.rint(x).astype(np.int64)


class OrbParams:
    """nFeatures, scaleFactor, nLevels, iniThFAST, minThFAST."""

    def __init__(self, n_features: int, scale_factor: float, n_levels: int,
                 ini_th_fast: int, min_th_fast: int):
        self.n_features = int(n_features)
        self.scale_factor = float(scale_factor)
        self.n_levels = int(n_levels)
        self.ini_th_fast = int(ini_th_fast)
        self.min_th_fast = int(min_th_fast)
        self.scale_factors = self.scale_factor ** np.arange(self.n_levels)

    def quotas(self) -> list[int]:
        """Geometric quota per level, the last level taking the rest."""
        factor = np.float32(1.0 / self.scale_factor)
        n_desired = np.float32(
            self.n_features * (1 - factor) / (1 - float(factor) ** self.n_levels)
        )
        quotas = [0] * self.n_levels
        total = 0
        for level in range(self.n_levels - 1):
            quotas[level] = int(cv_round(n_desired))
            total += quotas[level]
            n_desired = np.float32(n_desired * factor)
        quotas[-1] = max(self.n_features - total, 0)
        return quotas

    def level_sizes(self, h: int, w: int) -> list[tuple[int, int]]:
        inv = (1.0 / self.scale_factors).astype(np.float64)
        return [(int(cv_round(np.float64(h) * s)), int(cv_round(np.float64(w) * s))) for s in inv]


def linear_coeffs(dst_n: int, src_n: int):
    """cv2's source index and 11-bit taps (a0, a1) per destination index."""
    scale = src_n / dst_n
    d = np.arange(dst_n)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    left = s < 0
    f[left] = 0.0
    s[left] = 0
    right = s >= src_n - 1
    f[right] = 0.0
    s[right] = src_n - 1
    return s, cv_round((np.float32(1.0) - f) * np.float32(2048.0)), cv_round(f * np.float32(2048.0))


def blur_kernel() -> np.ndarray:
    """Integer 7-tap sigma=2 kernel summing to 2**16."""
    x = np.arange(-3, 4, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * 2.0 ** 2))
    g /= g.sum()
    ik = np.rint(g * (1 << BLUR_FRAC_BITS)).astype(np.int64)
    ik[3] += (1 << BLUR_FRAC_BITS) - ik.sum()
    return ik


def moment_weights() -> np.ndarray:
    """(2, 31, 31) int32 (w10, w01) over the circular patch."""
    umax = np.zeros(HALF_PATCH_SIZE + 1, dtype=np.int64)
    vmax = int(math.floor(HALF_PATCH_SIZE * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(HALF_PATCH_SIZE * math.sqrt(2.0) / 2))
    hp2 = HALF_PATCH_SIZE * HALF_PATCH_SIZE
    for v in range(vmax + 1):
        umax[v] = int(cv_round(math.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH_SIZE, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    r = np.arange(-HALF_PATCH_SIZE, HALF_PATCH_SIZE + 1)
    uu, vv = np.meshgrid(r, r)
    mask = np.abs(uu) <= umax[np.abs(vv)]
    return np.stack([np.where(mask, uu, 0), np.where(mask, vv, 0)]).astype(np.int32)


def brief_pattern() -> np.ndarray:
    """(2, 512) f32 pattern points (px, py); even = first point, odd = second."""
    px = BIT_PATTERN_31[:, [0, 2]].reshape(-1)
    py = BIT_PATTERN_31[:, [1, 3]].reshape(-1)
    return np.stack([px, py]).astype(np.float32)


def shelf_pack(heights, widths, w_comp: int, order=None):
    """First-fit shelf packing: (place[b] = (y0, x0), shelves [y0, h, x])."""
    shelves: list[list[int]] = []
    place: list = [None] * len(heights)
    y_total = 0
    for b in (range(len(heights)) if order is None else order):
        hb, wb = heights[b], widths[b]
        for s in shelves:
            if s[1] >= hb and s[2] + wb <= w_comp:
                place[b] = (s[0], s[2])
                s[2] += wb
                break
        else:
            shelves.append([y_total, hb, wb])
            place[b] = (y_total, 0)
            y_total += hb
    return place, shelves


def detection_layout(crop_shapes):
    """((h, w), [(y0, x0, ch, cw)], interior mask) of the detection composite:
    crops padded to 32-multiples, shelf-packed, each with its 3-px frame."""
    pads = [(-(-h // TILE) * TILE, -(-w // TILE) * TILE) for h, w in crop_shapes]
    w_comp = max(pw for _, pw in pads)
    place, shelves = shelf_pack([ph for ph, _ in pads], [pw for _, pw in pads], w_comp)
    h_comp = shelves[-1][0] + shelves[-1][1]
    meta = [(y0, x0, h, w) for (y0, x0), (h, w) in zip(place, crop_shapes)]
    mask = np.zeros((h_comp, w_comp), bool)
    for y0, x0, h, w in meta:
        mask[y0 + 3 : y0 + h - 3, x0 + 3 : x0 + w - 3] = True
    return (h_comp, w_comp), meta, mask


def merged_layout(block_shapes):
    """((h, w), place, interior mask) of the camera-merged bordered composite:
    blocks in shelf order (-width, -height, index)."""
    p = COMPOSITE_BAND
    hb = [h + 2 * p for h, _ in block_shapes]
    wb = [w + 2 * p for _, w in block_shapes]
    order = sorted(range(len(hb)), key=lambda b: (-wb[b], -hb[b], b))
    place, shelves = shelf_pack(hb, wb, max(wb), order=order)
    h_comp = shelves[-1][0] + shelves[-1][1]
    mask = np.zeros((h_comp, max(wb)), bool)
    for (y0, x0), (h, w) in zip(place, block_shapes):
        mask[y0 + p : y0 + p + h, x0 + p : x0 + p + w] = True
    return (h_comp, max(wb)), place, mask


# --- the stages --------------------------------------------------------------

def reflect101_index(n: int, p: int, device) -> torch.Tensor:
    i = torch.arange(-p, n + p, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def reflect101_pad(img: torch.Tensor, p: int) -> torch.Tensor:
    h, w = img.shape
    return img[reflect101_index(h, p, img.device)][:, reflect101_index(w, p, img.device)]


def build_pyramid(image: torch.Tensor, sizes, taps: dict) -> list[torch.Tensor]:
    """Level l is cv2's INTER_LINEAR 8u resize of the image, bit for bit."""
    s = image.to(torch.int32)
    rows = (s[:, taps["sx"]] * taps["ax0"] + s[:, taps["sx1"]] * taps["ax1"]) >> 4
    levels = [image]
    y = x = 0
    for dh, dw in sizes:
        r = rows[:, x : x + dw]
        sy, sy1 = taps["sy"][y : y + dh], taps["sy1"][y : y + dh]
        by0, by1 = taps["by0"][y : y + dh], taps["by1"][y : y + dh]
        out = ((by0[:, None] * r[sy]) >> 16) + ((by1[:, None] * r[sy1]) >> 16) + 2
        levels.append((out >> 2).clamp(0, 255).to(torch.uint8))
        y += dh
        x += dw
    return levels


def blur7(img: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable fixed-point blur, zero padding (the composite masks the rim)."""
    h, w = img.shape
    half = 1 << (BLUR_FRAC_BITS - 1)
    pad = torch.nn.functional.pad(img.to(torch.int32), (3, 3, 3, 3))
    hp = (sum(taps[i] * pad[:, i : i + w] for i in range(7)) + half) >> BLUR_FRAC_BITS
    vp = (sum(taps[i] * hp[i : i + h, :] for i in range(7)) + half) >> BLUR_FRAC_BITS
    return vp.clamp(0, 255).to(torch.uint8)


def fast_score(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Threshold-free FAST-9/16 score (the largest threshold at which a pixel
    is a corner) minus one, zero outside `mask`."""
    h, w = img.shape
    c = img.to(torch.int32)
    pad = torch.nn.functional.pad(c, (3, 3, 3, 3))
    ring = torch.stack([pad[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dx, dy in FAST_RING])
    d = ring - c[None]

    def arc_min(v):
        m2 = torch.minimum(v, torch.roll(v, -1, 0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, 0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, 0))
        return torch.minimum(m8, torch.roll(v, -8, 0)).amax(0)

    return torch.where(mask, torch.maximum(arc_min(d), arc_min(-d)) - 1, 0)


def nms3(score: torch.Tensor) -> torch.Tensor:
    h, w = score.shape
    p = torch.nn.functional.pad(score, (1, 1, 1, 1))
    keep = score > 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                keep &= score > p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
    return torch.where(keep, score, 0)


def retry_nms(raw: torch.Tensor, ini_th: int, min_th: int) -> torch.Tensor:
    hi = torch.where(raw >= ini_th, raw, 0)
    lo = torch.where(raw >= min_th, raw, 0)
    h, w = raw.shape
    tile_max = hi.view(h // TILE, TILE, w // TILE, TILE).amax(dim=(1, 3))
    use_hi = (tile_max > 0).repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)
    return nms3(torch.where(use_hi, hi, lo))


def cell_size_for(h: int, w: int, k: int) -> int:
    cell = max(int(math.sqrt(h * w / max(k, 1))), 1)
    while math.ceil(w / cell) * math.ceil(h / cell) > k:
        cell += 1
    return cell


def _grid_maxima(m: torch.Tensor, c: int):
    """Per-cell (max, y, x) over m; ties to the smallest in-cell flat index."""
    mh, mw = m.shape
    ny, nx = mh // c, mw // c
    cc = c * c
    dev = m.device
    ys = torch.arange(mh, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(mw, dtype=torch.int32, device=dev)[None, :]
    packed = m.to(torch.int32) * cc + (cc - 1 - ((ys % c) * c + (xs % c)))
    pmax = packed.view(ny, c, nx, c).amax(dim=(1, 3))
    l_win = (cc - 1) - pmax % cc
    cy = torch.arange(ny, dtype=torch.int32, device=dev)[:, None] * c + l_win // c
    cx = torch.arange(nx, dtype=torch.int32, device=dev)[None, :] * c + l_win % c
    return (pmax // cc).reshape(-1), cy.reshape(-1), cx.reshape(-1), packed, pmax


def _pad_to(a: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return torch.nn.functional.pad(a, (0, w - a.shape[1], 0, h - a.shape[0]))


def _candidate_pool(score: torch.Tensor, k: int):
    """(key, resp, ys, xs): cell winners, then the best residual of each 2x
    finer cell, then k zero pads."""
    h, w = score.shape
    cell = cell_size_for(h, w, k)
    ph, pw = math.ceil(h / cell) * cell, math.ceil(w / cell) * cell
    padded = _pad_to(score.to(torch.int32), ph, pw)
    cmax, wy, wx, packed, pmax = _grid_maxima(padded, cell)
    pmax_full = pmax.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
    resid = torch.where(packed == pmax_full, 0, padded)
    fine = max(cell // 2, 1)
    resid = _pad_to(resid, math.ceil(ph / fine) * fine, math.ceil(pw / fine) * fine)
    rresp, ry, rx, _, _ = _grid_maxima(resid, fine)
    zpad = torch.zeros(k, dtype=torch.int32, device=score.device)
    resp = torch.cat([cmax, rresp, zpad])
    is_winner = torch.cat([torch.ones_like(cmax), torch.zeros_like(rresp), zpad]).to(torch.float32)
    key = torch.where(resp > 0, is_winner * 1e6 + resp.to(torch.float32), -1.0)
    return key, resp, torch.cat([wy, ry, zpad]), torch.cat([wx, rx, zpad])


def select_topk(scores: list, ks: list) -> list:
    """Grid top-K of every map with one stable sort: (xy, resp, valid) each."""
    pools = [_candidate_pool(s, k) for s, k in zip(scores, ks)]
    pmax = max(p[0].shape[0] for p in pools)

    def stack(i, fill):
        return torch.stack(
            [torch.nn.functional.pad(p[i], (0, pmax - p[i].shape[0]), value=fill) for p in pools]
        )

    key, resp, ys, xs = stack(0, -1.0), stack(1, 0), stack(2, 0), stack(3, 0)
    kmax = max(ks)
    top_key, sel = torch.sort(key, dim=1, descending=True, stable=True)
    top_key, sel = top_key[:, :kmax], sel[:, :kmax]
    r, y, x = resp.gather(1, sel), ys.gather(1, sel), xs.gather(1, sel)
    return [
        (torch.stack([x[l, :k], y[l, :k]], dim=1), r[l, :k], top_key[l, :k] > 0)
        for l, k in enumerate(ks)
    ]


def windows(img: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor, nr: int, nc: int):
    """(K, nr, nc) windows at the starts, clamped into the image."""
    h, w = img.shape
    r = row0.to(torch.int64).clamp(0, h - nr)
    c = col0.to(torch.int64).clamp(0, w - nc)
    rows = r[:, None] + torch.arange(nr, device=img.device)
    cols = c[:, None] + torch.arange(nc, device=img.device)
    return img[rows[:, :, None], cols[:, None, :]]


def ic_angles(img: torch.Tensor, xy: torch.Tensor, weights: torch.Tensor, fdt) -> torch.Tensor:
    """Intensity-centroid angles in degrees [0, 360) at integer centres."""
    win = windows(img, xy[:, 1] - HALF_PATCH_SIZE, xy[:, 0] - HALF_PATCH_SIZE,
                  IC_WINDOW, IC_WINDOW)
    m = (win.to(torch.int32)[:, None] * weights[None]).sum(dim=(2, 3), dtype=torch.int32)
    m = m.to(fdt)
    ang = torch.rad2deg(torch.atan2(m[:, 1], m[:, 0]))
    return torch.where(ang < 0, ang + 360.0, ang).to(torch.float32)


def brief(img: torch.Tensor, xy: torch.Tensor, angles: torch.Tensor, pattern: torch.Tensor,
          fdt) -> torch.Tensor:
    """(K, 32) uint8 rBRIEF descriptors at f32 level coordinates `xy` of the
    sampling image (each inside its BRIEF_PAD border)."""
    ang = angles.to(fdt) * _FACTOR_PI
    a = torch.cos(ang)[:, None]
    b = torch.sin(ang)[:, None]
    px, py = pattern[0].to(fdt)[None, :], pattern[1].to(fdt)[None, :]
    ridx = torch.round(px * b + py * a).to(torch.int32) + PATCH_HALF
    cidx = torch.round(px * a - py * b).to(torch.int32) + PATCH_HALF
    cy = torch.round(xy[:, 1]).to(torch.int32) + BRIEF_PAD
    cx = torch.round(xy[:, 0]).to(torch.int32) + BRIEF_PAD
    win = windows(img, cy - PATCH_HALF, cx - PATCH_HALF, BRIEF_WINDOW, BRIEF_WINDOW)
    k = win.shape[0]
    flat = ridx.to(torch.int64) * BRIEF_WINDOW + cidx.to(torch.int64)
    samples = win.reshape(k, -1).gather(1, flat)
    bits = (samples[:, 0::2] < samples[:, 1::2]).to(torch.int32).reshape(-1, 32, 8)
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    return (bits << shifts).sum(dim=-1, dtype=torch.int32).to(torch.uint8)


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) int32 Hamming distances of (N, 32) uint8 descriptors."""
    wa = a.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    wb = b.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    x = wa[:, None, :] ^ wb[None, :, :]
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return ((x & 0xFF) + (x >> 8)).sum(dim=-1, dtype=torch.int32)


class StereoReference:
    """The plain stereo front-end of one geometry on one device."""

    def __init__(self, orb: OrbParams, image_hw: tuple, mbf: float, fx: float, device,
                 float_dtype=torch.float32):
        h, w = image_hw
        self.orb = orb
        self.image_hw = (int(h), int(w))
        self.mbf = float(mbf)
        self.fx = float(fx)
        self.fdt = float_dtype
        self.device = torch.device(device)
        dev = self.device
        sizes = orb.level_sizes(h, w)
        self.sizes = sizes
        self.quotas = orb.quotas()
        b = FAST_BORDER
        crops = [(hh - 2 * b, ww - 2 * b) for hh, ww in sizes]
        if not all(
            ch >= 7 and cw >= 7 and 0 < q <= ch * cw for (ch, cw), q in zip(crops, self.quotas)
        ):
            raise ValueError(f"{image_hw} with {orb.n_features} features is not the flat geometry")
        sx, ax0, ax1 = (np.concatenate(p) for p in zip(*[linear_coeffs(dw, w) for _, dw in sizes[1:]]))
        sy, by0, by1 = (np.concatenate(p) for p in zip(*[linear_coeffs(dh, h) for dh, _ in sizes[1:]]))
        taps = dict(sx=sx, sx1=np.minimum(sx + 1, w - 1), ax0=ax0, ax1=ax1,
                    sy=sy, sy1=np.minimum(sy + 1, h - 1), by0=by0, by1=by1)
        self.taps = {
            k: torch.from_numpy(v.astype(np.int64 if k[0] == "s" else np.int32)).to(dev)
            for k, v in taps.items()
        }
        self.blur_taps = torch.from_numpy(blur_kernel().astype(np.int32)).to(dev)
        self.weights = torch.from_numpy(moment_weights()).to(dev)
        self.pattern = torch.from_numpy(brief_pattern()).to(dev)
        _, self.det_meta, det_mask = detection_layout(crops * 2)
        self.det_shape = det_mask.shape
        self.det_mask = torch.from_numpy(det_mask).to(dev)
        _, place, merged_mask = merged_layout(sizes * 2)
        self.merged_shape = merged_mask.shape
        self.place = place
        self.merged_mask = torch.from_numpy(merged_mask).to(dev)
        n = len(sizes)
        p = COMPOSITE_BAND
        y0 = [[pl[0] for pl in place[c * n : (c + 1) * n]] for c in range(2)]
        x0 = [[pl[1] for pl in place[c * n : (c + 1) * n]] for c in range(2)]
        self.row_off = torch.tensor(y0, dtype=torch.int32, device=dev) + p
        self.col_off = torch.tensor(x0, dtype=torch.int32, device=dev) + p
        scales = orb.scale_factors.astype(np.float32)
        self.scale_factors = torch.from_numpy(scales).to(dev)
        self.inv_scale_factors = torch.from_numpy((np.float32(1.0) / scales).astype(np.float32)).to(dev)
        self.level_hw = torch.tensor(sizes, dtype=torch.int32, device=dev)
        scale_vec = np.repeat(np.asarray([1.0] + [float(s) for s in orb.scale_factors[1:]],
                                         np.float32), self.quotas)
        self.slot_scale = torch.from_numpy(scale_vec).to(dev)
        self.slot_octave = torch.from_numpy(
            np.repeat(np.arange(n, dtype=np.int32), self.quotas)).to(dev)
        row = np.concatenate([np.repeat(np.asarray(y, np.int32), self.quotas) for y in y0])
        col = np.concatenate([np.repeat(np.asarray(x, np.int32), self.quotas) for x in x0])
        off = torch.from_numpy(np.stack([col, row], axis=1)).to(dev)
        self.off_orient = off + p
        self.off_brief = off + p - BRIEF_PAD

    def _composites(self, pyrs):
        """The bordered composite and its sampling image (blurred interiors)."""
        p = COMPOSITE_BAND
        blocks = [img for pyr in pyrs for img in pyr]
        bordered = torch.zeros(self.merged_shape, dtype=torch.uint8, device=self.device)
        for img, (y0, x0) in zip(blocks, self.place):
            h, w = img.shape
            bordered[y0 : y0 + h + 2 * p, x0 : x0 + w + 2 * p] = reflect101_pad(img, p)
        sampling = torch.where(self.merged_mask, blur7(bordered, self.blur_taps), bordered)
        return bordered, sampling

    def _detect(self, pyrs) -> list:
        b = FAST_BORDER
        comp = torch.zeros(self.det_shape, dtype=torch.uint8, device=self.device)
        crops = [lvl[b:-b, b:-b] for pyr in pyrs for lvl in pyr]
        for crop, (y0, x0, h, w) in zip(crops, self.det_meta):
            comp[y0 : y0 + h, x0 : x0 + w] = crop
        score = retry_nms(fast_score(comp, self.det_mask), self.orb.ini_th_fast,
                          self.orb.min_th_fast)
        return [score[y0 : y0 + h, x0 : x0 + w] for (y0, x0, h, w) in self.det_meta]

    def features(self, pair: torch.Tensor):
        """Both cameras' (xy, response, angle, octave, valid, desc), and the
        bordered composite."""
        if tuple(pair.shape) != (2, *self.image_hw) or pair.dtype != torch.uint8:
            raise ValueError(f"expected a (2, {self.image_hw}) uint8 pair, got {tuple(pair.shape)}")
        pyrs = [build_pyramid(pair[c], self.sizes[1:], self.taps) for c in range(2)]
        scores = self._detect(pyrs)
        sel = select_topk(scores, self.quotas * 2)
        n = len(self.sizes)
        b = FAST_BORDER
        xy_c, resp_c, valid_c, safe = [], [], [], []
        for c in range(2):
            s = sel[c * n : (c + 1) * n]
            xy = torch.cat([t[0] for t in s]) + b
            valid = torch.cat([t[2] for t in s])
            xy_c.append(xy)
            resp_c.append(torch.cat([t[1] for t in s]))
            valid_c.append(valid)
            safe.append(torch.where(valid[:, None], xy, b + 3))
        bordered, sampling = self._composites(pyrs)
        xy_all = torch.cat(safe)
        angles = ic_angles(bordered, xy_all + self.off_orient, self.weights, self.fdt)
        desc = brief(sampling, (xy_all + self.off_brief).to(torch.float32), angles,
                     self.pattern, self.fdt)
        k = sum(self.quotas)
        out = []
        for c in range(2):
            v = valid_c[c]
            scaled = (xy_c[c].to(self.fdt) * self.slot_scale.to(self.fdt)[:, None]).to(torch.float32)
            out.append(dict(
                xy=torch.where(v[:, None], scaled, 0.0),
                response=torch.where(v, resp_c[c].to(torch.float32), 0.0),
                angle=torch.where(v, angles[c * k : (c + 1) * k], 0.0),
                octave=self.slot_octave,
                valid=v,
                desc=torch.where(v[:, None], desc[c * k : (c + 1) * k], 0),
            ))
        return out[0], out[1], bordered

    def _pairs(self, fl: dict, fr: dict, max_d: float) -> dict:
        """The masked Hamming match and the SAD strips' starts."""
        th_orb = (TH_HIGH + TH_LOW) // 2
        ul, vl = fl["xy"][:, 0], fl["xy"][:, 1]
        ur, vr = fr["xy"][:, 0], fr["xy"][:, 1]
        oct_l = fl["octave"].to(torch.int64)
        oct_r = fr["octave"].to(torch.int64)
        row = vl.to(torch.int32).to(torch.float32)
        r_r = 2.0 * self.scale_factors[oct_r]
        row_ok = (row[:, None] >= torch.floor(vr - r_r)[None, :]) & (
            row[:, None] <= torch.ceil(vr + r_r)[None, :])
        oct_ok = (oct_r[None, :] >= oct_l[:, None] - 1) & (oct_r[None, :] <= oct_l[:, None] + 1)
        u_ok = (ur[None, :] >= (ul - max_d)[:, None]) & (ur[None, :] <= ul[:, None])
        ok = row_ok & oct_ok & u_ok & fl["valid"][:, None] & fr["valid"][None, :]
        d = torch.where(ok, hamming_matrix(fl["desc"], fr["desc"]), BIG)
        best_dist = d.min(dim=1).values
        best_r = torch.argmin(d, dim=1)
        inv = self.inv_scale_factors[oct_l]
        sul = torch.round(ul * inv).to(torch.int32)
        svl = torch.round(vl * inv).to(torch.int32)
        sur0 = torch.round(ur[best_r] * inv).to(torch.int32)
        lh, lw = self.level_hw[oct_l, 0], self.level_hw[oct_l, 1]
        in_bounds = (
            (svl - SAD_W >= 0) & (svl + SAD_W + 1 <= lh)
            & (sul - SAD_W >= 0) & (sul + SAD_W + 1 <= lw)
            & (sur0 - SAD_L - SAD_W >= 0) & (sur0 + SAD_L + SAD_W + 1 <= lw)
        )
        wl, ww = 2 * SAD_W + 1, 2 * (SAD_L + SAD_W) + 1

        def clip(x, hi):
            return torch.minimum(torch.clamp(x, min=0), hi)

        cl_svl = clip(svl - SAD_W, lh - wl)
        return dict(
            tentative=best_dist < th_orb, in_bounds=in_bounds, sur0=sur0,
            row_l=self.row_off[0][oct_l] + cl_svl,
            col_l=self.col_off[0][oct_l] + clip(sul - SAD_W, lw - wl),
            row_r=self.row_off[1][oct_l] + cl_svl,
            col_r=self.col_off[1][oct_l] + clip(sur0 - SAD_L - SAD_W, lw - ww),
        )

    def _refine(self, fl: dict, bordered: torch.Tensor, pairs: dict, max_d: float):
        """(u_right, depth): the 11-slide SAD parabola and the median filter."""
        wl, ww = 2 * SAD_W + 1, 2 * (SAD_L + SAD_W) + 1
        fdt = self.fdt
        p_l = windows(bordered, pairs["row_l"], pairs["col_l"], wl, wl).to(torch.int32)
        p_r = windows(bordered, pairs["row_r"], pairs["col_r"], wl, ww).to(torch.int32)
        dists = torch.stack(
            [(p_l - p_r[:, :, j : j + wl]).abs().sum(dim=(1, 2)) for j in range(2 * SAD_L + 1)],
            dim=1,
        ).to(torch.float32)
        sad = dists.min(dim=1).values
        best_j = torch.argmin(dists, dim=1)
        inc_ok = (best_j > 0) & (best_j < 2 * SAD_L)
        jm = best_j.clamp(1, 2 * SAD_L - 1)
        d1, d2, d3 = (dists.gather(1, (jm + o)[:, None])[:, 0].to(fdt) for o in (-1, 0, 1))
        denom = 2.0 * (d1 + d3 - 2.0 * d2)
        delta = torch.where(denom != 0, (d1 - d3) / denom, 0.0)
        delta_ok = (delta >= -1.0) & (delta <= 1.0)
        ul = fl["xy"][:, 0].to(fdt)
        best_ur = self.scale_factors.to(fdt)[fl["octave"].to(torch.int64)] * (
            pairs["sur0"].to(fdt) + (best_j - SAD_L).to(fdt) + delta)
        disparity = ul - best_ur
        disp_ok = (disparity >= 0.0) & (disparity < max_d)
        clamped = disparity <= 0.0
        disparity = torch.where(clamped, 0.01, disparity)
        best_ur = torch.where(clamped, ul - 0.01, best_ur)
        ok = pairs["tentative"] & pairs["in_bounds"] & inc_ok & delta_ok & disp_ok
        n_ok = ok.sum()
        sorted_sad, _ = torch.sort(torch.where(ok, sad, float(BIG)))
        mid = torch.clamp(n_ok // 2, max=sad.shape[0] - 1).view(1)
        th = MEDIAN_FACTOR * sorted_sad.index_select(0, mid)[0]
        ok = ok & (n_ok > 0) & (sad < th)
        u_right = torch.where(ok, best_ur, -1.0).to(torch.float32)
        depth = torch.where(ok, torch.full_like(disparity, self.mbf) / disparity, -1.0)
        return u_right, depth.to(torch.float32)

    @torch.no_grad()
    def __call__(self, pair: torch.Tensor) -> torch.Tensor:
        """(2, H, W) uint8 -> the (K, 40) f32 packed block of the left camera."""
        fl, fr, bordered = self.features(pair)
        max_d = self.mbf / (self.mbf / self.fx)
        pairs = self._pairs(fl, fr, max_d)
        u_right, depth = self._refine(fl, bordered, pairs, max_d)
        cols = [fl["xy"][:, 0], fl["xy"][:, 1], fl["response"], fl["angle"],
                fl["octave"].to(torch.float32), fl["valid"].to(torch.float32), u_right, depth]
        return torch.cat([torch.stack(cols, dim=1), fl["desc"].to(torch.float32)], dim=1)
