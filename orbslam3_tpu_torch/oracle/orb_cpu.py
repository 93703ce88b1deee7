"""CPU (NumPy) golden-reference implementation of the ORB extraction pipeline.

This module is the *semantic specification* for the TPU device path in
``orbslam3_tpu.ops``: every device kernel must match these functions bit-exactly
(descriptors, blurred pyramid) or set-exactly (FAST keypoints).  The semantics
mirror the reference extractor (``ORB_SLAM3/src/ORBextractor.cc``) —
pyramid :1309-1329, FAST via the tile kernel semantics
(``src/OpenCL/Kernel/TileCalcKeypoints.cl:288-448``), octree distribution :584-774,
IC-angle :470-513 (with the *correct* full reduction, which the reference's OpenCL
kernel omits — the CPU path is the spec), rBRIEF :105-149 — re-derived here in
array form, not translated line-by-line.

Two deliberate, documented deviations from OpenCV internals (see tests):
 - bilinear resize follows cv2's 8u fixed-point scheme (11-bit coeffs, 22-bit
   accumulator) and matches cv2.resize bit-exactly;
 - Gaussian blur uses 16-bit-fraction fixed point with symmetric rounding.
   cv2's 8u path quantises coefficients to 8 fractional bits and truncates
   per-step (asymmetric impulse response); ours is symmetric and deterministic.
   Parity with cv2 is asserted at tolerance, oracle<->device is bit-exact.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from orbslam3_tpu_torch.ops.brief_pattern import BIT_PATTERN_31

PATCH_SIZE = 31
HALF_PATCH_SIZE = 15
EDGE_THRESHOLD = 19
FAST_BORDER = EDGE_THRESHOLD - 3  # = 16; detection crop border (ORBextractor.cc:960)

# FAST-16 Bresenham circle offsets (dx, dy), index 0 at 12 o'clock, clockwise —
# standard FAST-9_16 geometry (TileCalcKeypoints.cl:200-230 packs the same ring).
FAST_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)

BLUR_FRAC_BITS = 16


def cv_round(x):
    """cvRound: round-half-to-even (x86 rint), as used throughout the reference."""
    return np.rint(x).astype(np.int64)


# ---------------------------------------------------------------------------
# Scale pyramid bookkeeping (ORBextractor ctor semantics, ORBextractor.cc:410-463)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PyramidParams:
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7

    @property
    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels)

    @property
    def inv_scale_factors(self) -> np.ndarray:
        return 1.0 / self.scale_factors

    @property
    def level_sigma2(self) -> np.ndarray:
        return self.scale_factors ** 2

    def features_per_level(self) -> np.ndarray:
        """Geometric quota per level; last level takes the remainder."""
        factor = np.float32(1.0 / self.scale_factor)
        n_desired = np.float32(
            self.n_features * (1 - factor) / (1 - float(factor) ** self.n_levels)
        )
        quotas = np.zeros(self.n_levels, dtype=np.int64)
        total = 0
        for level in range(self.n_levels - 1):
            quotas[level] = int(cv_round(n_desired))
            total += quotas[level]
            n_desired = np.float32(n_desired * factor)
        quotas[self.n_levels - 1] = max(self.n_features - total, 0)
        return quotas

    def level_sizes(self, h: int, w: int) -> list[tuple[int, int]]:
        """(h, w) of every pyramid level: cvRound(dim * invScale)."""
        inv = self.inv_scale_factors
        return [
            (int(cv_round(np.float64(h) * s)), int(cv_round(np.float64(w) * s)))
            for s in inv.astype(np.float64)
        ]


# ---------------------------------------------------------------------------
# Bilinear resize — cv2 8u INTER_LINEAR fixed-point semantics
# ---------------------------------------------------------------------------

def _linear_coeffs(dst_n: int, src_n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-dst-index source index + 11-bit fixed-point tap pair (a0, a1)."""
    scale = src_n / dst_n
    d = np.arange(dst_n)
    # cv2 computes the fractional coordinate and taps in float32
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    left = s < 0
    f[left] = 0.0
    s[left] = 0
    right = s >= src_n - 1
    f[right] = 0.0
    s[right] = src_n - 1
    a1 = cv_round(f * np.float32(2048.0))
    a0 = cv_round((np.float32(1.0) - f) * np.float32(2048.0))
    return s, a0, a1


def _row_coeffs(dst_n: int, src_n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The vertical pass's (first source row, 11-bit taps): cv2 clips the
    two ROWS into the image but keeps the fraction, so a row past an edge
    (upscaling) still weighs the edge row twice (its two truncations)."""
    d = np.arange(dst_n)
    f = ((d + 0.5) * (src_n / dst_n) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    return s, cv_round((np.float32(1.0) - f) * np.float32(2048.0)), cv_round(f * np.float32(2048.0))


def resize_linear_u8(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2.resize(src, (dw, dh), INTER_LINEAR) for uint8, bit-exact."""
    sh, sw = src.shape
    sx, ax0, ax1 = _linear_coeffs(dw, sw)
    sy, by0, by1 = _row_coeffs(dh, sh)
    s = src.astype(np.int64)
    sx1 = np.minimum(sx + 1, sw - 1)
    rows = s[:, sx] * ax0 + s[:, sx1] * ax1  # horizontal pass, 8u*11bit -> int
    sy1 = np.clip(sy + 1, 0, sh - 1)
    sy = np.clip(sy, 0, sh - 1)
    r0 = rows[sy, :]
    r1 = rows[sy1, :]
    out = (((by0[:, None] * (r0 >> 4)) >> 16) + ((by1[:, None] * (r1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# 7x7 sigma=2 Gaussian blur — 16-bit-fraction fixed point, reflect-101 borders
# ---------------------------------------------------------------------------

def gaussian_kernel7_fixed() -> np.ndarray:
    """Integer 7-tap kernel summing to exactly 2**BLUR_FRAC_BITS."""
    x = np.arange(-3, 4, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * 2.0 ** 2))
    g /= g.sum()
    ik = np.rint(g * (1 << BLUR_FRAC_BITS)).astype(np.int64)
    ik[3] += (1 << BLUR_FRAC_BITS) - ik.sum()
    return ik


_BLUR_K = gaussian_kernel7_fixed()


def gaussian_blur7_u8(img: np.ndarray) -> np.ndarray:
    """Separable fixed-point blur; each pass rounds symmetrically (+half >> 16)."""
    half = 1 << (BLUR_FRAC_BITS - 1)
    pad = np.pad(img.astype(np.int64), 3, mode="reflect")  # reflect-101
    h, w = img.shape
    hp = sum(int(_BLUR_K[i]) * pad[:, i : i + w] for i in range(7))
    hp = (hp + half) >> BLUR_FRAC_BITS
    vp = sum(int(_BLUR_K[i]) * hp[i : i + h, :] for i in range(7))
    out = (vp + half) >> BLUR_FRAC_BITS
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# FAST-9/16 detection with corner score + 3x3 NMS + two-threshold tiles
# ---------------------------------------------------------------------------

def fast_score_map(img: np.ndarray, threshold: int) -> np.ndarray:
    """Per-pixel FAST corner score; 0 where not a corner at `threshold`.

    A pixel is a corner iff >=9 contiguous ring pixels are all brighter than
    center+t or all darker than center-t (strict).  The score is the largest t
    for which the pixel is still a corner == max over 9-arcs of min over the
    arc of the absolute excess, minus 1 (equals the reference's binary search
    over thresholds, TileCalcKeypoints.cl:165-188, in closed form).
    Border of 3 pixels has score 0.
    """
    h, w = img.shape
    center = img.astype(np.int32)
    ring = np.zeros((16, h, w), dtype=np.int32)
    for k, (dx, dy) in enumerate(FAST_RING):
        ring[k] = np.roll(np.roll(center, -dy, axis=0), -dx, axis=1)
    d_bright = ring - center[None]  # ring brighter than center
    d_dark = -d_bright

    def arc_score(d):
        # min over each circular window of 9, then max over the 16 windows
        m2 = np.minimum(d, np.roll(d, -1, axis=0))
        m4 = np.minimum(m2, np.roll(m2, -2, axis=0))
        m8 = np.minimum(m4, np.roll(m4, -4, axis=0))
        m9 = np.minimum(m8, np.roll(d, -8, axis=0))
        return m9.max(axis=0)

    score = np.maximum(arc_score(d_bright), arc_score(d_dark)) - 1
    score = np.where(score >= threshold, score, 0)
    score[:3, :] = 0
    score[-3:, :] = 0
    score[:, :3] = 0
    score[:, -3:] = 0
    return score


def nms3(score: np.ndarray) -> np.ndarray:
    """Strict 3x3 non-max suppression (TileCalcKeypoints.cl:248-260)."""
    h, w = score.shape
    p = np.pad(score, 1, mode="constant", constant_values=0)
    keep = np.ones_like(score, dtype=bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            keep &= score > p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
    return np.where(keep & (score > 0), score, 0)


def fast_keypoints_two_threshold(
    crop: np.ndarray, ini_th: int, min_th: int, tile: int = 32
) -> np.ndarray:
    """Detect on a detection crop with per-tile threshold fallback.

    Mirrors tileCalcKeypoints_kernel: each 32x32 tile detects at `ini_th`; a
    tile yielding zero corners retries at `min_th` (:384-409).  NMS runs on
    the per-tile-threshold score map.  Returns (N, 3) array of (x, y, score)
    in crop coordinates.
    """
    hi = fast_score_map(crop, ini_th)
    lo = fast_score_map(crop, min_th)
    h, w = crop.shape
    th, tw = math.ceil(h / tile), math.ceil(w / tile)
    hi_pad = np.zeros((th * tile, tw * tile), hi.dtype)
    hi_pad[:h, :w] = hi
    tile_has = hi_pad.reshape(th, tile, tw, tile).max(axis=(1, 3)) > 0
    use_hi = np.repeat(np.repeat(tile_has, tile, axis=0), tile, axis=1)[:h, :w]
    score = np.where(use_hi, hi, lo)
    score = nms3(score)
    ys, xs = np.nonzero(score)
    return np.stack([xs, ys, score[ys, xs]], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Octree keypoint distribution (exact sequential semantics)
# ---------------------------------------------------------------------------

@dataclass
class _Node:
    ul: tuple[int, int]
    ur: tuple[int, int]
    bl: tuple[int, int]
    br: tuple[int, int]
    keys: list = field(default_factory=list)
    no_more: bool = False

    def divide(self):
        half_x = math.ceil((self.ur[0] - self.ul[0]) / 2)
        half_y = math.ceil((self.br[1] - self.ul[1]) / 2)
        ulx, uly = self.ul
        cx, cy = ulx + half_x, uly + half_y
        urx = self.ur[0]
        bry = self.br[1]
        n1 = _Node((ulx, uly), (cx, uly), (ulx, cy), (cx, cy))
        n2 = _Node((cx, uly), (urx, uly), (cx, cy), (urx, cy))
        n3 = _Node((ulx, cy), (cx, cy), (ulx, bry), (cx, bry))
        n4 = _Node((cx, cy), (urx, cy), (cx, bry), (urx, bry))
        for kp in self.keys:
            x, y = kp[0], kp[1]
            if x < cx:
                (n1 if y < cy else n3).keys.append(kp)
            else:
                (n2 if y < cy else n4).keys.append(kp)
        for n in (n1, n2, n3, n4):
            if len(n.keys) == 1:
                n.no_more = True
        return n1, n2, n3, n4


def distribute_octree(
    kps: np.ndarray, min_x: int, max_x: int, min_y: int, max_y: int, n: int
) -> np.ndarray:
    """Exact port of the recursive quadtree spreading (ORBextractor.cc:584-774).

    kps: (N, 3) of (x, y, response) in crop coordinates (origin at min border).
    Returns the selected subset, one best-response keypoint per final node.
    """
    if len(kps) == 0:
        return kps
    n_ini = round((max_x - min_x) / (max_y - min_y))
    n_ini = max(n_ini, 1)
    hx = (max_x - min_x) / n_ini
    nodes: list[_Node] = []
    for i in range(n_ini):
        node = _Node(
            (int(hx * i), 0), (int(hx * (i + 1)), 0),
            (int(hx * i), max_y - min_y), (int(hx * (i + 1)), max_y - min_y),
        )
        nodes.append(node)
    for kp in kps:
        idx = int(kp[0] / hx)
        nodes[min(idx, n_ini - 1)].keys.append(kp)
    nodes = [nd for nd in nodes if nd.keys]
    for nd in nodes:
        if len(nd.keys) == 1:
            nd.no_more = True

    finished = False
    while not finished:
        prev_size = len(nodes)
        to_expand: list[_Node] = []
        new_nodes: list[_Node] = []
        for nd in nodes:
            if nd.no_more:
                new_nodes.append(nd)
                continue
            children = [c for c in nd.divide() if c.keys]
            # reference push_front: children go to the head of the list
            for c in children:
                new_nodes.insert(0, c)
                if len(c.keys) > 1:
                    to_expand.append(c)
        nodes = new_nodes
        if len(nodes) >= n or len(nodes) == prev_size:
            finished = True
        elif len(nodes) + 3 * len(to_expand) > n:
            while not finished:
                prev_size = len(nodes)
                # expand biggest nodes first (stable sort by key count)
                prev = sorted(to_expand, key=lambda nd: len(nd.keys))
                to_expand = []
                for nd in reversed(prev):
                    nodes.remove(nd)
                    children = [c for c in nd.divide() if c.keys]
                    for c in children:
                        nodes.insert(0, c)
                        if len(c.keys) > 1:
                            to_expand.append(c)
                    if len(nodes) >= n:
                        break
                if len(nodes) >= n or len(nodes) == prev_size:
                    finished = True

    out = []
    for nd in nodes:
        keys = np.asarray(nd.keys)
        out.append(keys[np.argmax(keys[:, 2])])
    return np.asarray(out, dtype=np.float32)


# ---------------------------------------------------------------------------
# IC-angle orientation
# ---------------------------------------------------------------------------

def ic_angle_umax() -> np.ndarray:
    """Circular patch row extents u_max[v], v in [0, 15] (ctor, :459-474)."""
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
    return umax


_UMAX = ic_angle_umax()


def ic_moment_weights() -> tuple[np.ndarray, np.ndarray]:
    """31x31 integer weight masks for (m10, m01) over the circular patch."""
    r = HALF_PATCH_SIZE
    u = np.arange(-r, r + 1)
    v = np.arange(-r, r + 1)
    uu, vv = np.meshgrid(u, v)  # vv rows = dy, uu cols = dx
    mask = np.abs(uu) <= _UMAX[np.abs(vv)]
    w10 = np.where(mask, uu, 0).astype(np.int64)
    w01 = np.where(mask, vv, 0).astype(np.int64)
    return w10, w01


_W10, _W01 = ic_moment_weights()


def ic_angles(img: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Intensity-centroid angle (degrees, [0, 360)) for integer keypoint centers.

    pts: (N, 2) float (x, y) — sampled at integer positions (keypoints from FAST
    are integral at this stage).  Full moment reduction (the semantic spec; the
    reference's OpenCL kernel forgets the cross-lane reduction, its CPU path
    and upstream CUDA do reduce — SURVEY §2 G4).  Moments are exact integer
    sums, so summation order is irrelevant (device path matches bit-exactly).
    """
    r = HALF_PATCH_SIZE
    im = img.astype(np.int64)
    out = np.zeros(len(pts), dtype=np.float32)
    for i, (x, y) in enumerate(pts[:, :2].astype(np.int64)):
        patch = im[y - r : y + r + 1, x - r : x + r + 1]
        m10 = int((patch * _W10).sum())
        m01 = int((patch * _W01).sum())
        out[i] = math.degrees(math.atan2(m01, m10)) % 360.0
    return out


# ---------------------------------------------------------------------------
# rBRIEF descriptors
# ---------------------------------------------------------------------------

BRIEF_PAD = 19  # descriptor sampling border (EDGE_THRESHOLD in the reference)


def brief_sampling_image(raw: np.ndarray, blurred: np.ndarray) -> np.ndarray:
    """Composite the descriptor-sampling buffer: blurred interior inside a
    BRIEF_PAD-wide reflect-101 border of the *raw* level image.

    The rotated pattern reaches up to 18 px from the center while keypoints
    sit only >= 16 px from the level edge, so samples can fall up to 2 px
    outside the level.  The reference keeps each pyramid level as a view
    inside a 19-px reflect-101-bordered allocation built from the resized
    (unblurred) image and blurs only the interior view — out-of-view samples
    therefore read *unblurred* reflected pixels.  This reproduces exactly
    that buffer.
    """
    pad = np.pad(raw, BRIEF_PAD, mode="reflect")  # reflect-101
    pad[BRIEF_PAD:-BRIEF_PAD, BRIEF_PAD:-BRIEF_PAD] = blurred
    return pad


def brief_descriptors(
    blurred: np.ndarray,
    pts: np.ndarray,
    angles_deg: np.ndarray,
    trig: tuple[np.ndarray, np.ndarray] | None = None,
    raw: np.ndarray | None = None,
) -> np.ndarray:
    """256-bit rBRIEF (32 uint8) with rotated pattern; bit-exact spec.

    Sampling: offset = (round(px*sin + py*cos), round(px*cos - py*sin)) as
    (row, col) around the rounded keypoint center; bit i of byte b set when
    I(p0) < I(p1) for pair index 16*b + 2i (computeOrbDescriptor, :105-149).
    Angles are quantised through float32 radians like the reference.
    Samples come from the bordered composite (`brief_sampling_image`); pass
    `raw` to enable the exact border semantics (defaults to reflecting the
    blurred image itself when absent).
    """
    n = len(pts)
    desc = np.zeros((n, 32), dtype=np.uint8)
    pat = BIT_PATTERN_31  # (256, 4)
    img = brief_sampling_image(
        raw if raw is not None else blurred, blurred
    ).astype(np.int32)
    for i in range(n):
        if trig is not None:
            a = np.float32(trig[0][i])
            b = np.float32(trig[1][i])
        else:
            ang = np.float32(angles_deg[i]) * np.float32(math.pi / 180.0)
            a = np.float32(math.cos(ang))
            b = np.float32(math.sin(ang))
        cy = int(cv_round(pts[i, 1])) + BRIEF_PAD
        cx = int(cv_round(pts[i, 0])) + BRIEF_PAD
        # all rotation arithmetic in float32, matching the f32 device path
        pf = pat.astype(np.float32)
        px0, py0, px1, py1 = pf[:, 0], pf[:, 1], pf[:, 2], pf[:, 3]
        r0 = cv_round(px0 * b + py0 * a) + cy
        c0 = cv_round(px0 * a - py0 * b) + cx
        r1 = cv_round(px1 * b + py1 * a) + cy
        c1 = cv_round(px1 * a - py1 * b) + cx
        t0 = img[r0, c0]
        t1 = img[r1, c1]
        bits = (t0 < t1).astype(np.uint8)  # (256,)
        desc[i] = np.packbits(bits.reshape(32, 8)[:, ::-1], axis=1).ravel()
    return desc


# ---------------------------------------------------------------------------
# Full extraction pipeline (operator(), ORBextractor.cc:1227-1303)
# ---------------------------------------------------------------------------

@dataclass
class OracleFeatures:
    keypoints: np.ndarray  # (N, 5): x, y, response, octave, angle (level-0 coords)
    descriptors: np.ndarray  # (N, 32) uint8
    mono_index: int


def build_pyramid(image: np.ndarray, params: PyramidParams) -> list[np.ndarray]:
    """Every level is a cv2-bit-exact INTER_LINEAR resize of the NATIVE image.

    Deliberate deviation from the reference, which resizes each level from
    the previous one (ORBextractor.cc:1309-1329): direct-from-native avoids
    compounding interpolation blur AND removes the 8-deep sequential
    dependency chain, letting the device build all levels as a handful of
    large fused matmuls (the chain was 60% of extraction latency)."""
    levels = [image]
    for (lh, lw) in params.level_sizes(*image.shape)[1:]:
        levels.append(resize_linear_u8(image, lh, lw))
    return levels


def extract(
    image: np.ndarray,
    params: PyramidParams = PyramidParams(),
    lapping_area: tuple[float, float] = (-1.0, -1.0),
) -> OracleFeatures:
    pyramid = build_pyramid(image, params)
    quotas = params.features_per_level()
    scale_factors = params.scale_factors
    all_kps = []
    all_desc = []
    for level, img in enumerate(pyramid):
        h, w = img.shape
        min_b = FAST_BORDER
        max_bx, max_by = w - FAST_BORDER, h - FAST_BORDER
        crop = img[min_b:max_by, min_b:max_bx]
        raw = fast_keypoints_two_threshold(crop, params.ini_th_fast, params.min_th_fast)
        sel = distribute_octree(raw, min_b, max_bx, min_b, max_by, int(quotas[level]))
        if len(sel) == 0:
            continue
        pts = sel[:, :2] + min_b  # add border back (addBorder_kernel semantics)
        angles = ic_angles(img, pts)
        blurred = gaussian_blur7_u8(img)
        desc = brief_descriptors(blurred, pts, angles, raw=img)
        scale = scale_factors[level]
        kps = np.zeros((len(sel), 5), dtype=np.float32)
        kps[:, :2] = pts * scale if level != 0 else pts
        kps[:, 2] = sel[:, 2]
        kps[:, 3] = level
        kps[:, 4] = angles
        all_kps.append(kps)
        all_desc.append(desc)
    if not all_kps:
        return OracleFeatures(np.zeros((0, 5), np.float32), np.zeros((0, 32), np.uint8), 0)
    kps = np.concatenate(all_kps)
    desc = np.concatenate(all_desc)
    # mono/stereo split by lapping area (operator() tail, :1289-1303)
    in_lap = (kps[:, 0] >= lapping_area[0]) & (kps[:, 0] <= lapping_area[1])
    order = np.concatenate([np.nonzero(~in_lap)[0], np.nonzero(in_lap)[0][::-1]])
    return OracleFeatures(kps[order], desc[order], int((~in_lap).sum()))
