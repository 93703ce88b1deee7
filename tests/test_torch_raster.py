"""`utils/raster.py` pixel for pixel against cv2, and the synthetic texture.

`fill_poly` is held to `cv2.fillPoly` on polygons drawn from
`make_texture`'s own distribution and on edge cases: collinear, repeated
and self-crossing vertices, polygons partly and wholly off the image,
one-pixel polygons, large coordinates, one and three channels.  The
8-connected line, the thickness-1 rectangle and the filled circle are
held to cv2 clipped at every edge.  The port's `make_texture`, which now
draws its polygons with `fill_poly`, equals the JAX package's (drawn with
cv2.fillPoly) for seeds 0-2 at 512 and once at 2048.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from orbslam3_tpu_torch.utils import raster  # noqa: E402


def _polygons(seed: int, n: int):
    """(h, w, int32 points) cases, one kind in turn."""
    rng = np.random.default_rng(seed)
    for t in range(n):
        h, w = int(rng.integers(1, 64)), int(rng.integers(1, 64))
        kind, nv = t % 8, int(rng.integers(1, 9))
        if kind == 0:  # make_texture's polygons, around the image
            cx, cy = rng.integers(-4, 68, 2)
            radius = rng.uniform(2.5, 11.0)
            angs = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(3, 7))))
            pts = np.stack([cx + radius * np.cos(angs),
                            cy + radius * rng.uniform(0.4, 1.6) * np.sin(angs)], axis=1)
        elif kind == 1:  # self-crossing, partly off the image
            pts = rng.integers(-8, 72, (nv, 2))
        elif kind == 2:  # collinear
            p, d = rng.integers(-3, 60, 2), rng.integers(-4, 5, 2)
            pts = p + np.outer(rng.integers(-6, 7, nv), d)
        elif kind == 3:  # one pixel, its vertex repeated
            pts = np.repeat(rng.integers(-2, 64, (1, 2)), nv, axis=0)
        elif kind == 4:  # repeated vertices
            pts = rng.integers(-4, 68, (nv, 2))[rng.integers(0, nv, nv + 3)]
        elif kind == 5:  # wholly off the image, on every side
            pts = rng.integers(-30, -1, (nv, 2)) + rng.choice([0, 100], 2)
        elif kind == 6:  # large coordinates
            pts = rng.integers(-3000, 3000, (nv, 2))
        else:  # axis-aligned boxes across the edges
            x0, y0 = rng.integers(-10, 60, 2)
            x1, y1 = x0 + rng.integers(0, 20), y0 + rng.integers(0, 20)
            pts = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
        yield h, w, np.asarray(pts).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_fill_poly_equals_cv2(seed):
    rng = np.random.default_rng(100 + seed)
    n = 0
    for h, w, pts in _polygons(seed, 400):
        channels = 3 if n % 3 == 0 else 1
        shape = (h, w, 3) if channels == 3 else (h, w)
        want = rng.integers(0, 256, shape, dtype=np.uint8)
        got = want.copy()
        value = tuple(int(v) for v in rng.integers(0, 256, channels))
        cv2.fillPoly(want, [pts], value)
        assert raster.fill_poly(got, pts, value) is got
        assert np.array_equal(got, want), (h, w, pts.tolist())
        n += 1


def test_lines_rectangles_and_circles_equal_cv2():
    rng = np.random.default_rng(3)
    for _ in range(600):
        h, w = int(rng.integers(1, 48)), int(rng.integers(1, 48))
        p1, p2 = (tuple(int(v) for v in rng.integers(-20, 68, 2)) for _ in range(2))
        radius = int(rng.integers(0, 9))
        for draw, pixels in (
            (lambda im: cv2.line(im, p1, p2, 255, 1, cv2.LINE_8),
             raster.line_pixels(p1, p2, (w, h))),
            (lambda im: cv2.rectangle(im, p1, p2, 255, 1), raster.rectangle_pixels(p1, p2, (w, h))),
            (lambda im: cv2.circle(im, p1, radius, 255, -1),
             raster.circle_pixels(p1, radius, (w, h))),
        ):
            want = np.zeros((h, w), np.uint8)
            draw(want)
            got = np.zeros((h, w), np.uint8)
            got[pixels[1], pixels[0]] = 255
            assert np.array_equal(got, want), (h, w, p1, p2, radius)


def test_stamp_paints_later_positions_over_earlier_ones():
    img = np.zeros((6, 6, 3), np.uint8)
    dot = raster.unique_offsets(raster.circle_pixels((0, 0), 1))
    raster.stamp(img, [[2, 2], [3, 2], [5, 5]], dot, [[1, 1, 1], [2, 2, 2], [3, 3, 3]])
    want = np.zeros((6, 6, 3), np.uint8)
    for (x, y), c in (((2, 2), 1), ((3, 2), 2), ((5, 5), 3)):
        cv2.circle(want, (x, y), 1, (c, c, c), -1)
    assert np.array_equal(img, want)


@pytest.mark.parametrize("size,seeds", [(512, (0, 1, 2)), (2048, (0,))])
def test_make_texture_equals_the_reference(size, seeds):
    from orbslam3_tpu.utils.synth import make_texture as ref_texture
    from orbslam3_tpu_torch.utils.synth import make_texture

    for seed in seeds:
        got = make_texture(size, seed)
        assert got.dtype == np.uint8 and got.shape == (size, size)
        assert np.array_equal(got, ref_texture(size, seed)), seed
