"""The port's viewer draws and writes without cv2, pixel for pixel cv2 5.x's.

`FrameDrawer.draw_snapshot` (grey to BGR, keypoint rectangles and dots
clipped at the image's edges, the status line in FONT_HERSHEY_PLAIN) is
held to the same drawing made with cv2 and to the JAX package's
`draw_snapshot`, on a snapshot with keypoints on all four borders and a
status text with every printable character.  The glyph table
(`orbslam3_tpu_torch/utils/hershey_plain.py`) is generated here, from
cv2, and the committed one must equal a fresh rendering; regenerate it
with `python tests/test_torch_viewer.py`.  cv2 5.x draws this font
anti-aliased, as the table holds; cv2 4.x draws it with no
anti-aliasing, so the comparisons of text with cv2 (and the JAX
package's drawing, which calls cv2) run under cv2 5.x only, while the
tests of the table itself, of the PNG writer and of the map's plan view
run with any cv2 or none.  The PNG the viewer writes reads back through
cv2.imread as cv2.imwrite's does.  A process that refuses cv2, PIL and
matplotlib renders a texture and draws and writes viewer frames and
maps.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from orbslam3_tpu_torch.utils import raster

try:
    import cv2
except ImportError:
    cv2 = None

needs_cv2 = pytest.mark.skipif(cv2 is None, reason="compares with cv2, which is not installed")
# the glyph table is cv2 5.x's anti-aliased FONT_HERSHEY_PLAIN; cv2 4.x draws
# the font with no anti-aliasing, so its text is not the table's
needs_cv2_5 = pytest.mark.skipif(
    cv2 is None or int(cv2.__version__.split(".")[0]) < 5,
    reason="the glyph table is cv2 5.x's anti-aliased text; cv2 4.x draws it without",
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE = os.path.join(REPO, "orbslam3_tpu_torch", "utils", "hershey_plain.py")
PRINTABLE = "".join(chr(c) for c in range(32, 127))


# --- the glyph table ---------------------------------------------------------
def render_glyphs() -> dict:
    """{byte: (advance, (dx, dy, a, ...))} of each printable ASCII
    character in FONT_HERSHEY_PLAIN at scale 1, thickness 1: the coverage
    a (0-255) of each pixel cv2.putText touches, as (x, y) offsets from
    the origin (drawn in 255 on 0, where it writes a itself), and the
    pen's advance, found as the one shift at which a marker glyph drawn
    after the character lands (cv2.getTextSize is not the advance)."""
    h, w, ox, oy = 64, 128, 32, 40

    def coverage(text: str) -> np.ndarray:
        img = np.zeros((h, w), np.uint8)
        cv2.putText(img, text, (ox, oy), cv2.FONT_HERSHEY_PLAIN, 1, 255, 1)
        ys, xs = np.nonzero(img)
        assert len(xs) == 0 or (xs.min() > 0 and ys.min() > 0 and xs.max() < w - 1
                                and ys.max() < h - 1), text
        return img

    marker = coverage("H").astype(np.int64)
    table = {}
    for b in range(32, 127):
        alone, pair = coverage(chr(b)), coverage(chr(b) + "H")
        fits = []
        for s in range(-16, 48):
            a = np.roll(marker, s, axis=1)
            blend = (alone.astype(np.int64) * (255 - a) + 255 * a + 127) // 255
            fits += [s] if np.array_equal(blend, pair) else []
        assert len(fits) == 1, (chr(b), fits)
        ys, xs = np.nonzero(alone)
        table[b] = (fits[0], tuple(v for x, y in zip(xs.tolist(), ys.tolist())
                                   for v in (x - ox, y - oy, int(alone[y, x]))))
    return table


def table_source(table: dict) -> str:
    head = '''"""FONT_HERSHEY_PLAIN as cv2.putText draws it at scale 1, thickness 1.

Generated from OpenCV's `FONT_HERSHEY_PLAIN` (cv2.putText of each
printable ASCII character at an integer origin, 255 on 0, cv2 5.0) by
tests/test_torch_viewer.py, which regenerates it and holds it equal.
`GLYPHS[byte] = (advance, (dx0, dy0, a0, dx1, dy1, a1, ...))`: each pixel
the character covers, as an offset from the pen at the text's origin (x
right, y down, the origin on the baseline) with its coverage a (1-255),
and the pen's advance in pixels.

cv2 5.0 draws this font anti-aliased, whatever the lineType (cv2 4.x
draws it with no anti-aliasing, so this is cv2 5.x's text).  At an
integer origin and scale 1 a glyph's coverage moves with the origin
unchanged, and the pen advances by whole pixels; a string is drawn glyph
by glyph, each blending its colour into the image at its pixels,
v = (v (255 - a) + colour a + 127) // 255, per channel
(`utils.raster.put_text`).
"""

GLYPHS = {
'''
    body = []
    for b, (advance, cells) in sorted(table.items()):
        inner = textwrap.fill(", ".join(map(str, cells)) + ("," if len(cells) == 1 else ""),
                              width=88, initial_indent=" " * 8, subsequent_indent=" " * 8)
        body.append(f"    {b}: ({advance}, (  # {chr(b)!r}\n{inner}\n    )),\n"
                    if cells else f"    {b}: ({advance}, ()),  # {chr(b)!r}\n")
    return head + "".join(body) + "}\n"


@needs_cv2_5
def test_glyph_table_equals_a_fresh_rendering():
    from orbslam3_tpu_torch.utils.hershey_plain import GLYPHS

    assert GLYPHS == render_glyphs()


@needs_cv2_5
def test_glyphs_are_translation_invariant():
    """Coverage values included: the glyphs move with an integer origin."""
    for text, (x, y) in ((PRINTABLE[:40], (3, 30)), (PRINTABLE[40:], (7, 33))):
        a = np.zeros((48, 640), np.uint8)
        b = np.zeros((48, 640), np.uint8)
        cv2.putText(a, text, (x, y), cv2.FONT_HERSHEY_PLAIN, 1, 255, 1)
        cv2.putText(b, text, (x + 5, y + 4), cv2.FONT_HERSHEY_PLAIN, 1, 255, 1)
        assert np.array_equal(a[:-4, :-5], b[4:, 5:])


@needs_cv2_5
@pytest.mark.parametrize("text", [PRINTABLE, "OK  KFs: 12  MPs: 3456  inliers: 789", "tab\there\x7f\x01~"])
def test_put_text_equals_cv2(text):
    """Blended into a random background in a random colour, at origins
    that put the text across each of the image's edges."""
    rng = np.random.default_rng(len(text))
    for org in ((10, 30), (-37, 30), (900, 30), (10, 5), (10, 41), (-5, -2)):
        for channels in (1, 3):
            want = rng.integers(0, 256, (40, 1100, channels), dtype=np.uint8).squeeze()
            got = want.copy()
            color = tuple(int(v) for v in rng.integers(0, 256, channels))
            cv2.putText(want, text, org, cv2.FONT_HERSHEY_PLAIN, 1, color, 1)
            raster.put_text(got, text, org, color)
            assert np.array_equal(got, want), (org, channels)


def test_put_text_refuses_text_beyond_ascii():
    with pytest.raises(ValueError):
        raster.put_text(np.zeros((20, 40), np.uint8), "é", (2, 15), 255)


def test_put_text_paints_the_glyph_table():
    """Without cv2: each glyph blends its table coverage into the image at
    the pen, and a string moves with an integer origin unchanged."""
    from orbslam3_tpu_torch.utils.hershey_plain import GLYPHS

    rng = np.random.default_rng(7)
    for b, (_, cells) in GLYPHS.items():
        bg = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        color = rng.integers(0, 256, 3)
        got = raster.put_text(bg.copy(), chr(b), (20, 30), tuple(int(c) for c in color))
        want = bg.astype(np.int64)
        for dx, dy, a in np.array(cells, np.int64).reshape(-1, 3):
            want[30 + dy, 20 + dx] = (want[30 + dy, 20 + dx] * (255 - a) + color * a + 127) // 255
        assert np.array_equal(got, want), chr(b)
    a = raster.put_text(np.zeros((48, 1100), np.uint8), PRINTABLE, (3, 30), 255)
    b = raster.put_text(np.zeros((48, 1100), np.uint8), PRINTABLE, (8, 34), 255)
    assert a.any() and np.array_equal(a[:-4, :-5], b[4:, 5:])


# --- draw_snapshot -----------------------------------------------------------
H, W = 96, 1100  # wide enough for the 95 printable characters


def _snapshot():
    """Keypoints on all four borders and corners, within 3 px of them and
    inside, matched and not, some overlapping; a status text with every
    printable character."""
    rng = np.random.default_rng(4)
    image = rng.integers(0, 256, (H, W), dtype=np.uint8)
    edge = np.array([
        [0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1], [0.7, 40.2], [W - 0.3, 50.9],
        [300.5, 0.4], [301.2, H - 0.6], [1.9, 2.1], [2.9, H - 3.2], [W - 2.5, 3.7],
        [W - 3.1, H - 2.2], [500.0, 1.0], [501.0, 2.0], [502.0, 3.0],
    ], np.float32)
    inside = rng.uniform([0, 0], [W, H], (200, 2)).astype(np.float32)
    kps = np.concatenate([edge, inside, inside[:20] + 1.5])
    matched = rng.random(len(kps)) < 0.5
    stats = {"n_keyframes": 12, "n_map_points": 3456}
    return image, kps, matched, "OK " + PRINTABLE, stats, 789


def _cv2_drawing(snap):
    image, kps, matched, state, stats, inliers = snap
    img = cv2.cvtColor(image, cv2.COLOR_GRAY2BGR)
    for i in range(len(kps)):
        x, y = int(kps[i, 0]), int(kps[i, 1])
        if matched[i]:
            cv2.rectangle(img, (x - 3, y - 3), (x + 3, y + 3), (0, 255, 0), 1)
            cv2.circle(img, (x, y), 1, (0, 255, 0), -1)
        else:
            cv2.circle(img, (x, y), 1, (120, 120, 120), -1)
    txt = (f"{state}  KFs: {stats['n_keyframes']}  MPs: {stats['n_map_points']}"
           f"  inliers: {inliers}")
    cv2.putText(img, txt, (10, img.shape[0] - 10), cv2.FONT_HERSHEY_PLAIN, 1, (255, 255, 255), 1)
    return img


@needs_cv2_5
def test_draw_snapshot_equals_cv2_and_the_reference():
    from orbslam3_tpu.utils.viewer import FrameDrawer as RefFrameDrawer
    from orbslam3_tpu_torch.utils.viewer import FrameDrawer

    snap = _snapshot()
    port, ref = FrameDrawer(None), RefFrameDrawer(None)
    port._snap = ref._snap = snap
    got = port.draw_snapshot()
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    assert np.array_equal(got, _cv2_drawing(snap))
    assert np.array_equal(got, ref.draw_snapshot())


@needs_cv2
def test_written_png_reads_back_as_cv2_writes(tmp_path):
    from orbslam3_tpu_torch.utils import imageio

    img = _cv2_drawing(_snapshot())
    imageio.imwrite(str(tmp_path / "port.png"), img)
    cv2.imwrite(str(tmp_path / "cv2.png"), img)
    got = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(got, cv2.imread(str(tmp_path / "cv2.png"), cv2.IMREAD_UNCHANGED))
    assert np.array_equal(got, img)


def test_map_render_puts_keyframe_centres_at_their_pixels(tmp_path):
    """The plan view scales x and z to fit 880x660 with a 20 px margin, z
    up: a map spanning 839 x 619 world units draws one unit a pixel, the
    keyframe centres in blue, the map points in grey."""
    from types import SimpleNamespace

    from orbslam3_tpu_torch.utils import imageio
    from orbslam3_tpu_torch.utils.viewer import MapDrawer

    centres = [(100.0, 5.0, 200.0), (400.0, -3.0, 300.0), (700.0, 0.0, 100.0)]
    kfs = [SimpleNamespace(camera_center=lambda c=c: np.array(c),
                           get_best_covisibility_keyframes=lambda n: []) for c in centres]
    points = [SimpleNamespace(position=np.array(p)) for p in
              ((0.0, 0.0, 0.0), (839.0, 1.0, 619.0), (600.0, 2.0, 500.0))]
    atlas_map = SimpleNamespace(get_all_map_points=lambda: points, get_all_keyframes=lambda: kfs)
    system = SimpleNamespace(atlas=SimpleNamespace(get_current_map=lambda: atlas_map))
    path = str(tmp_path / "map.png")
    MapDrawer(system).render(path)
    img = imageio.imread(path, unchanged=True)
    assert img.shape == (660, 880, 3) and img.dtype == np.uint8
    for x, _, z in centres:
        assert tuple(img[639 - int(z), 20 + int(x)]) == (255, 0, 0), (x, z)
    for x, z in ((0, 0), (839, 619), (600, 500)):
        assert tuple(img[639 - z, 20 + x]) == (160, 160, 160), (x, z)
    assert tuple(img[5, 5]) == (255, 255, 255)


_NO_CV2_SCRIPT = textwrap.dedent(
    """
    import os, sys


    class _Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "orbslam3_tpu", "cv2", "PIL", "matplotlib"):
                raise ImportError("the port must not import " + name)
            return None


    sys.meta_path.insert(0, _Refuse())
    import numpy as np
    from orbslam3_tpu_torch import Pinhole, PyramidParams, stereo_sequence
    from orbslam3_tpu_torch.slam.system import System
    from orbslam3_tpu_torch.utils import imageio
    from orbslam3_tpu_torch.utils.synth import make_texture
    from orbslam3_tpu_torch.utils.viewer import Viewer

    out = sys.argv[1]
    np.save(os.path.join(out, "texture.npy"), make_texture(256, 1))
    cam = Pinhole([150.0, 150.0, 80.0, 60.0])
    sysm = System(cam, 18.0, PyramidParams(n_features=300), device="cpu")
    viewer = Viewer(sysm, os.path.join(out, "viz"), map_every=2)
    for k, (l, r, _) in enumerate(stereo_sequence(3, cam, 0.12, 120, 160, seed=1)):
        sysm.track_stereo(l, r, timestamp=k / 20.0)
        viewer.update(l)
    sysm.shutdown()
    names = sorted(os.listdir(os.path.join(out, "viz")))
    assert names == ["frame_00000.png", "frame_00001.png", "frame_00002.png",
                     "map_00000.png", "map_00002.png"], names
    for name in names:
        img = imageio.imread(os.path.join(out, "viz", name), unchanged=True)
        assert img.ndim == 3 and img.dtype == np.uint8, name
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("cv2", "PIL", "matplotlib", "jax"))
    assert not leaked, leaked
    print("NO_CV2_OK")
    """
)


@needs_cv2
def test_texture_and_viewer_without_cv2_pil_or_matplotlib(tmp_path):
    from orbslam3_tpu.utils.synth import make_texture as ref_texture

    proc = subprocess.run(
        [sys.executable, "-c", _NO_CV2_SCRIPT, str(tmp_path)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_CV2_OK" in proc.stdout
    assert np.array_equal(np.load(tmp_path / "texture.npy"), ref_texture(256, 1))
    frame = cv2.imread(str(tmp_path / "viz" / "frame_00002.png"))
    assert frame.shape == (120, 160, 3)


if __name__ == "__main__":
    with open(TABLE, "w") as f:
        f.write(table_source(render_glyphs()))
    print("wrote", TABLE)
