"""Raster drawing in numpy, pixel for pixel OpenCV's (modules/imgproc/src/
drawing.cpp) for the calls the port makes, so that no module of the port
needs cv2:

- `fill_poly(img, pts, value)`: `cv2.fillPoly(img, [pts], value)` for
  int32 points, lineType 8, shift 0.  OpenCV draws it in two steps:
  `CollectPolyEdges` draws every edge with the 8-connected `Line`
  (Bresenham through `LineIterator`, clipped to the image by `clipLine`)
  and turns each edge that is not horizontal into a `PolyEdge`: x in
  16-bit fixed point (`XY_SHIFT`) from the vertices, or, where the edge
  leaves the image, from the ends `clipLine` leaves (their rows too,
  unless they share one), extended to the edge's own rows with the
  slope truncated toward zero.  `FillEdgeCollection` then walks the
  scanlines: on each row the active edges (y0 <= y < y1) are sorted by x
  and filled in pairs, from the first x rounded up to the second rounded
  down.  A closed polygon crosses every row an even number of times, so
  the pairs are consecutive in x order whatever order ties take.  This
  is what the cv2 5.0 wheel computes, held to it on random and
  degenerate polygons by tests/test_torch_raster.py.
- `line_pixels`: the pixels of `cv2.line(img, p1, p2, c, 1, LINE_8)`.
- `rectangle_pixels`: `cv2.rectangle(img, p1, p2, c, 1)` (thickness 1,
  lineType 8, shift 0): the closed `PolyLine` of its four corners, each
  side a `Line`.
- `circle_pixels`: `cv2.circle(img, c, r, color, -1)` (filled, lineType
  8, shift 0): the spans of OpenCV's integer midpoint `Circle`.
- `put_text(img, text, org, color)`: `cv2.putText(img, text, org,
  FONT_HERSHEY_PLAIN, 1, color, 1)`, anti-aliased as cv2 5.0 draws it,
  from the glyph coverage table in `utils/hershey_plain.py` (cv2 4.x
  draws this font with no anti-aliasing: its text is not this one).
- `stamp(img, xy, shapes, colors, which)`: pixel sets painted at many
  integer positions, later positions over earlier ones, as a loop of
  cv2 calls paints.

The pixel functions take an image size to clip to, or none.  A shape
whose pixels are translation invariant (integer end points, centres and
origins) and whose clipping only drops the pixels outside the image can
be stamped: rectangles with axis-aligned sides (clipLine moves an end
point along the side to the edge) and filled circles (each span is
clipped on its own) are; `stamp` clips to the image.
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.utils.hershey_plain import GLYPHS

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int) -> tuple:
    """cv::clipLine(Size2l(w, h), pt1, pt2) on Python ints: (inside, x1,
    y1, x2, y2), the end points as clipLine leaves them, moved in part
    even when it reports the line outside."""
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        # double arithmetic, truncated toward zero, as the C++ casts
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _segments(lines: list, size) -> tuple:
    """The pixels (xs, ys) of 8-connected `Line`s, int64, in drawing order.

    `LineIterator(img, p1, p2, 8, leftToRight=true)`: clipped to the image
    first; the end points swapped so that x grows; along the major axis
    one pixel a step, dx + 1 pixels; its error term starts at
    dx - 2 dy and a minor step follows each negative one, so the minor
    offset at step k is ceil((2 dy k - dx) / (2 dx))."""
    starts, steps = [], []
    for x1, y1, x2, y2 in lines:
        x1, y1, x2, y2 = int(x1), int(y1), int(x2), int(y2)
        if size is not None:
            w, h = size
            if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
                inside, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
                if not inside:
                    continue
        dx, dy = x2 - x1, y2 - y1
        if dx < 0:
            x1, y1, dx, dy = x2, y2, -dx, -dy
        sy = -1 if dy < 0 else 1
        dy = abs(dy)
        vert = dy > dx
        major, minor = (dy, dx) if vert else (dx, dy)
        starts.append((x1, y1, sy, vert, major, minor))
        steps.append(major + 1)
    if not starts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    x1, y1, sy, vert, major, minor = (np.repeat(np.array(c, np.int64), steps) for c in zip(*starts))
    first = np.repeat(np.cumsum(steps) - steps, steps)
    k = np.arange(len(x1), dtype=np.int64) - first
    span = np.maximum(2 * major, 1)
    m = -((major - 2 * minor * k) // span)  # ceil((2 minor k - major) / (2 major))
    m = np.where(major > 0, m, 0)
    vert = vert.astype(bool)
    xs = x1 + np.where(vert, m, k)
    ys = y1 + sy * np.where(vert, k, m)
    return xs, ys


def line_pixels(p1, p2, size=None) -> tuple:
    """(xs, ys) that cv2.line(img, p1, p2, color, 1, LINE_8) sets on an
    image of `size` (w, h); unclipped without one."""
    return _segments([(*p1, *p2)], size)


def rectangle_pixels(p1, p2, size=None) -> tuple:
    """(xs, ys) that cv2.rectangle(img, p1, p2, color, 1) sets: its four
    sides in PolyLine's order, the last corner to the first first."""
    (x1, y1), (x2, y2) = p1, p2
    corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    sides = [(*corners[i - 1], *corners[i]) for i in range(4)]
    return _segments(sides, size)


def circle_pixels(center, radius: int, size=None) -> tuple:
    """(xs, ys) that cv2.circle(img, center, radius, color, -1) sets
    (filled, LINE_8, shift 0): OpenCV's `Circle` walks the octant with an
    integer error term and fills four spans a step."""
    cx, cy = int(center[0]), int(center[1])
    xs, ys = [], []
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, (int(radius) << 1) - 1
    while dx >= dy:
        for y, xa, xb in (
            (cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
            (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy),
        ):
            if size is not None:
                w, h = size
                if not 0 <= y < h:
                    continue
                xa, xb = max(xa, 0), min(xb, w - 1)
            xs.extend(range(xa, xb + 1))
            ys.extend([y] * max(xb - xa + 1, 0))
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return np.array(xs, np.int64), np.array(ys, np.int64)


def unique_offsets(*pixel_sets) -> np.ndarray:
    """The union of (xs, ys) pixel sets as a sorted (n, 2) int64 array."""
    xy = np.concatenate([np.stack(p, axis=1) for p in pixel_sets])
    return np.unique(xy, axis=0)


def stamp(img: np.ndarray, xy, shapes, colors, which=None) -> np.ndarray:
    """Paint pixel offset sets at integer positions, clipped to the image,
    in place.  `xy` (m, 2) positions (x, y); `shapes` one (n, 2) offset
    array or a list of them, `which` (m,) the shape of each position;
    `colors` one colour or (m, C) rows.  A pixel that two positions cover
    takes the later position's colour, as a loop of cv2 calls leaves it."""
    h, w = img.shape[:2]
    xy = np.asarray(xy, np.int64).reshape(-1, 2)
    if isinstance(shapes, np.ndarray):
        shapes, which = [shapes], np.zeros(len(xy), np.int64)
    pts, owner = [], []
    for k, offsets in enumerate(shapes):
        idx = np.nonzero(np.asarray(which) == k)[0]
        offsets = np.asarray(offsets, np.int64).reshape(-1, 2)
        pts.append((xy[idx, None, :] + offsets[None]).reshape(-1, 2))
        owner.append(np.repeat(idx, len(offsets)))
    pts, owner = np.concatenate(pts), np.concatenate(owner)
    order = np.argsort(owner, kind="stable")
    pts, owner = pts[order], owner[order]
    keep = (pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0) & (pts[:, 1] < h)
    flat, owner = pts[keep, 1] * w + pts[keep, 0], owner[keep]
    # each pixel's last writer: its first occurrence in reverse order
    pix, first = np.unique(flat[::-1], return_index=True)
    last = owner[::-1][first]
    colors = np.asarray(colors, img.dtype).reshape(-1, *img.shape[2:])
    img[pix // w, pix % w] = colors[last] if len(colors) > 1 else colors[0]
    return img


def fill_poly(img: np.ndarray, pts: np.ndarray, value) -> np.ndarray:
    """cv2.fillPoly(img, [pts], value) for one polygon of int32 (n, 2)
    points (x, y), lineType 8, shift 0, on a uint8 image of one channel or
    more; in place, returned."""
    h, w = img.shape[:2]
    pts = np.asarray(pts).reshape(-1, 2)
    n = len(pts)
    if n == 0:
        return img
    verts = [(int(x), int(y)) for x, y in pts]
    outline = []
    edges = []  # (y0, y1, x at y0, dx), x in XY_SHIFT fixed point
    x0, y0 = verts[-1]
    for x1, y1 in verts:
        outline.append((x0, y0, x1, y1))
        # CollectPolyEdges: the edge's ends in fixed point; where the drawn
        # line leaves the image, x from clipLine's ends, y too unless they
        # share a row
        p0x, p0y, p1x, p1y = x0 << XY_SHIFT, y0, x1 << XY_SHIFT, y1
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            _, t0x, t0y, t1x, t1y = clip_line(w, h, x0, y0, x1, y1)
            p0x, p1x = t0x << XY_SHIFT, t1x << XY_SHIFT
            if t0y != t1y:
                p0y, p1y = t0y, t1y
        if y0 != y1:
            num, den = p1x - p0x, p1y - p0y
            dx = abs(num) // abs(den) * (1 if (num < 0) == (den < 0) else -1)  # C division
            if y0 < y1:
                edges.append((y0, y1, p0x + (y0 - p0y) * dx, dx))
            else:
                edges.append((y1, y0, p1x + (y1 - p1y) * dx, dx))
        x0, y0 = x1, y1
    xs, ys = _segments(outline, (w, h))
    img[ys, xs] = value
    if len(edges) < 2:
        return img
    e = np.array(edges, np.int64)
    rows = np.arange(max(int(e[:, 0].min()), 0), min(int(e[:, 1].max()), h), dtype=np.int64)
    if len(rows) == 0:
        return img
    active = (e[None, :, 0] <= rows[:, None]) & (rows[:, None] < e[None, :, 1])
    x = e[None, :, 2] + (rows[:, None] - e[None, :, 0]) * e[None, :, 3]
    x = np.sort(np.where(active, x, np.iinfo(np.int64).max), axis=1)
    n_active = active.sum(axis=1)
    pair = np.arange(0, x.shape[1] - 1, 2)
    live = pair[None, :] + 1 < n_active[:, None]
    x1 = (x[:, pair] + XY_ONE - 1) >> XY_SHIFT  # ceil
    x2 = x[:, pair + 1] >> XY_SHIFT  # floor
    draw = live & (x1 < w) & (x2 >= 0)
    r, c = np.nonzero(draw)
    if len(r) == 0:
        return img
    x1 = np.maximum(x1[r, c], 0)
    x2 = np.minimum(x2[r, c], w - 1)
    # the spans' pixels: a running count over each row's span starts and
    # ends, within the spans' bounding box
    y, c0, c1 = rows[r] - rows[0], int(x1.min()), int(x2.max()) + 1
    cover = np.zeros((len(rows), c1 - c0 + 1), np.int32)
    np.add.at(cover, (y, x1 - c0), 1)
    np.add.at(cover, (y, x2 + 1 - c0), -1)
    fill = np.cumsum(cover, axis=1)[:, :-1] > 0
    img[rows[0]:rows[-1] + 1, c0:c1][fill] = value
    return img


def put_text(img: np.ndarray, text: str, org, color) -> np.ndarray:
    """cv2.putText(img, text, org, FONT_HERSHEY_PLAIN, 1, color, 1) at an
    integer origin (bottomLeftOrigin false), on a uint8 image of one
    channel or more; in place, returned.

    A control character draws '?', as OpenCV's readCheck maps it; text
    beyond ASCII raises ValueError (cv2 5.0 draws it from fonts this table
    does not hold).  Glyph by glyph at the pen, the coverage `a` of
    `hershey_plain.GLYPHS` blends the colour into the pixels inside the
    image: v = (v (255 - a) + colour a + 127) // 255."""
    if not text.isascii():
        raise ValueError(f"put_text draws ASCII text only, not {text!r}")
    h, w = img.shape[:2]
    scalar = np.zeros(4, np.int64)  # cv::Scalar: the channels not given are 0
    given = np.asarray(color, np.int64).reshape(-1)
    scalar[: len(given)] = given
    color = scalar[: img.shape[2] if img.ndim == 3 else 1]
    pen, oy = int(org[0]), int(org[1])
    for b in text.encode("ascii"):
        advance, cells = GLYPHS[b if 32 <= b < 127 else ord("?")]
        if cells:
            dx, dy, a = np.array(cells, np.int64).reshape(-1, 3).T
            x, y = dx + pen, dy + oy
            keep = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            x, y, a = x[keep], y[keep], a[keep].reshape(-1, *([1] * (img.ndim - 2)))
            v = img[y, x].astype(np.int64)
            img[y, x] = ((v * (255 - a) + color.reshape(img.shape[2:] or 1) * a + 127) // 255)
        pen += advance
    return img
