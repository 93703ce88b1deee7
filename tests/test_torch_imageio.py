"""The port's PNG reader and writer (`orbslam3_tpu_torch.utils.imageio`)
against cv2, which the reference's drivers read every image with.

PNGs are encoded here with every row filter (None, Sub, Up, Average,
Paeth) forced row by row, at sizes hypothesis draws, for the four kinds
the drivers meet: 8-bit grey (EuRoC, TUM-VI, KITTI), 16-bit grey
(TUM-RGBD depth), 8-bit RGB (TUM-RGBD colour) and RGBA.  `imread` must
equal `cv2.imread` bit for bit, read as grey and unchanged; the native
unfilter must equal its numpy plain version; `imwrite`'s files must read
back through cv2 unchanged.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from orbslam3_tpu_torch.utils import imageio

KINDS = {  # colour type, bit depth, samples per pixel
    "grey8": (0, 8, 1), "grey16": (0, 16, 1), "rgb8": (2, 8, 3), "rgba8": (6, 8, 4),
}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(kind: int, cur: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """PNG filter `kind` applied to one row (the encoder side)."""
    cur, prev = cur.astype(np.int64), prev.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    pred = {0: 0, 1: left, 2: prev, 3: (left + prev) >> 1, 4: _paeth(left, prev, up_left)}[kind]
    return ((cur - pred) & 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(samples: np.ndarray, colour: int, depth: int, filters, interlace: int = 0) -> bytes:
    """A PNG of `samples` (file channel order) with row r filtered by
    filters[r % len(filters)]."""
    h = samples.shape[0]
    data = samples.astype(">u2") if depth == 16 else samples
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(h, -1)
    bpp = max(1, (samples.shape[2] if samples.ndim == 3 else 1) * depth // 8)
    out, prev = [], np.zeros(rows.shape[1], np.uint8)
    for r in range(h):
        f = filters[r % len(filters)]
        out.append(bytes([f]) + _filter_row(f, rows[r], prev, bpp).tobytes())
        prev = rows[r]
    w = samples.shape[1]
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
            + _chunk(b"IDAT", zlib.compress(b"".join(out)))
            + _chunk(b"IEND", b""))


def _samples(kind: str, h: int, w: int, rng) -> np.ndarray:
    colour, depth, ch = KINDS[kind]
    dtype = np.uint16 if depth == 16 else np.uint8
    shape = (h, w, ch) if ch > 1 else (h, w)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    if ch > 1:  # some grey pixels: libpng keeps R where R == G == B
        img[::3, ::2, 1] = img[::3, ::2, 0]
        img[::3, ::2, 2] = img[::3, ::2, 0]
    return img


@pytest.mark.parametrize("kind", sorted(KINDS))
@settings(max_examples=12, deadline=None, database=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2**16))
def test_imread_matches_cv2_with_every_filter(tmp_path_factory, kind, h, w, seed):
    rng = np.random.default_rng(seed)
    colour, depth, _ = KINDS[kind]
    img = _samples(kind, h, w, rng)
    filters = list(rng.permutation(5)) + list(rng.integers(0, 5, 3))
    path = str(tmp_path_factory.mktemp(kind) / "f.png")
    with open(path, "wb") as f:
        f.write(encode_png(img, colour, depth, filters))
    got = imageio.imread(path)
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    got = imageio.imread(path, unchanged=True)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_imread_matches_cv2_on_cv2_files(tmp_path, kind):
    """Files cv2 itself wrote (libpng's adaptive filter choice) at the
    EuRoC geometry, a smooth image so every filter type occurs."""
    colour, depth, ch = KINDS[kind]
    yy, xx = np.mgrid[0:480, 0:752]
    base = (np.sin(xx / 23.0) + np.cos(yy / 17.0)) * 0.25 + 0.5
    scale = 65535 if depth == 16 else 255
    planes = [np.rint(base * scale), np.rint(base[::-1] * scale), np.rint((1 - base) * scale),
              np.full_like(base, scale // 2)]
    dtype = np.uint16 if depth == 16 else np.uint8
    img = np.stack(planes[:ch], -1).astype(dtype) if ch > 1 else planes[0].astype(dtype)
    path = str(tmp_path / "cv2.png")
    assert cv2.imwrite(path, img)
    for flag, kw in ((cv2.IMREAD_GRAYSCALE, {}), (cv2.IMREAD_UNCHANGED, {"unchanged": True})):
        np.testing.assert_array_equal(imageio.imread(path, **kw), cv2.imread(path, flag))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_matches_plain(bpp):
    rng = np.random.default_rng(bpp)
    h, row_bytes = 9, bpp * 7
    raw = rng.integers(0, 256, (h, row_bytes + 1), dtype=np.uint8)
    raw[:, 0] = np.arange(h) % 5
    got = imageio.unfilter(raw.reshape(-1), h, row_bytes, bpp)
    np.testing.assert_array_equal(got, imageio.unfilter_plain(raw.reshape(-1), h, row_bytes, bpp))


def test_unfilter_rejects_an_unknown_filter_type():
    raw = np.zeros((3, 5), np.uint8)
    raw[1, 0] = 5
    for fn in (imageio.unfilter, imageio.unfilter_plain):
        with pytest.raises(ValueError, match="row 1"):
            fn(raw.reshape(-1), 3, 4, 1)


@pytest.mark.parametrize("kind", ["grey8", "grey16", "bgr8"])
def test_imwrite_round_trips_through_cv2(tmp_path, kind):
    rng = np.random.default_rng(4)
    img = {
        "grey8": rng.integers(0, 256, (31, 45), dtype=np.uint8),
        "grey16": rng.integers(0, 65536, (31, 45), dtype=np.uint16),
        "bgr8": rng.integers(0, 256, (31, 45, 3), dtype=np.uint8),
    }[kind]
    path = str(tmp_path / "w.png")
    imageio.imwrite(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(imageio.imread(path, unchanged=True), img)


@pytest.mark.parametrize("case", ["palette", "adam7", "grey_alpha", "rgb16", "grey4"])
def test_unsupported_pngs_raise_naming_the_file(tmp_path, case):
    colour, depth, interlace = {
        "palette": (3, 8, 0), "adam7": (0, 8, 1), "grey_alpha": (4, 8, 0),
        "rgb16": (2, 16, 0), "grey4": (0, 4, 0),
    }[case]
    path = str(tmp_path / f"{case}.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, depth, colour, 0, 0, interlace))
                + _chunk(b"IDAT", zlib.compress(b"")) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=f"{case}.png"):
        imageio.imread(path)


def test_colour_with_a_gamma_chunk_read_as_grey_raises(tmp_path):
    img = np.zeros((2, 3, 3), np.uint8)
    data = encode_png(img, 2, 8, [0])
    i = data.index(b"IDAT") - 4
    data = data[:i] + _chunk(b"gAMA", struct.pack(">I", 45455)) + data[i:]
    path = str(tmp_path / "gamma.png")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match="gAMA"):
        imageio.imread(path)
    assert imageio.imread(path, unchanged=True).shape == (2, 3, 3)


def test_missing_file_gives_none_and_damage_raises(tmp_path):
    assert imageio.imread(str(tmp_path / "absent.png")) is None
    path = str(tmp_path / "bad.png")
    data = bytearray(encode_png(np.zeros((3, 3), np.uint8), 0, 8, [0]))
    data[-20] ^= 1  # inside the IDAT chunk: its CRC no longer holds
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="bad.png"):
        imageio.imread(path)
