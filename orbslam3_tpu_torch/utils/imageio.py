"""PNG read and write with no cv2 and no PIL: zlib from the standard
library, the row unfilter in C++ (``native/src/png_unfilter.cpp``, built
with g++ into ``_build/`` at first use).

`imread` returns what ``cv2.imread`` returns, bit for bit, for the PNGs the
dataset drivers read (EuRoC / TUM-VI / KITTI greyscale frames, TUM-RGBD's
colour frames and 16-bit depth):

- ``imread(path)`` is ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``: uint8
  (H, W).  16-bit grey keeps its high byte (libpng's ``png_set_strip_16``).
  Colour becomes grey inside libpng, not through ``cvtColor``: OpenCV asks
  ``png_set_rgb_to_gray(png, 1, 0.299, 0.587)``, which libpng turns into
  15-bit coefficients (9797, 19234, 3737) and applies with truncation,
  ``(9797 R + 19234 G + 3737 B) >> 15``; alpha is dropped.
- ``imread(path, unchanged=True)`` is ``cv2.IMREAD_UNCHANGED``: grey as
  uint8 or native-endian uint16 (H, W) (TUM-RGBD's depth is big-endian in
  the file), colour as (H, W, 3) BGR or (H, W, 4) BGRA uint8.

Handled: non-interlaced 8- and 16-bit greyscale, 8-bit RGB and RGBA.
Anything else (palette, bit depths below 8, grey + alpha, 16-bit colour,
Adam7, transparency chunks, or a gamma / colour-space chunk on a colour
image read as grey, where libpng would convert through its gamma tables)
raises, naming the file.  A missing file gives None, as cv2.imread does.
If the native unfilter cannot be built, reading raises.

`imwrite` writes grey uint8 / uint16 (H, W) or BGR uint8 (H, W, 3) with
filter 0 on every row.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from orbslam3_tpu_torch._build import host_library

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native", "src", "png_unfilter.cpp")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# colour type -> samples per pixel (0 grey, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}
# libpng's png_set_rgb_to_gray_fixed of OpenCV's (0.299, 0.587): 15-bit
# red and green, blue the rest of 32768
_GREY_RGB = (9797, 19234, 32768 - 9797 - 19234)
_COLOUR_CONVERTING_CHUNKS = (b"gAMA", b"sRGB", b"iCCP", b"cHRM")
_lib = None


def _native():
    global _lib
    if _lib is None:
        so = host_library(_SRC, "libpng_unfilter", ".so", _FLAGS)
        if so is None:
            raise RuntimeError(f"the native PNG unfilter did not build (g++ on {_SRC})")
        lib = ctypes.CDLL(so)
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The unfiltered (height, row_bytes) uint8 rows of `raw` (each row a
    filter-type byte then `row_bytes` bytes), in C++."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError(f"{raw.size} bytes of image data, expected {height * (row_bytes + 1)}")
    out = np.empty((height, row_bytes), np.uint8)
    rc = _native().png_unfilter(raw.ctypes.data, height, row_bytes, bpp, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"row {-rc - 1}: filter type outside 0-4")
    return out


def unfilter_plain(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """`unfilter` in numpy: the plain version the native one is held to."""
    rows = np.asarray(raw, np.uint8).reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int64)
    for r in range(height):
        kind, src = int(rows[r, 0]), rows[r, 1:].astype(np.int64)
        cur = np.zeros(row_bytes, np.int64)
        if kind == 0:
            cur = src
        elif kind == 1:
            for i in range(row_bytes):
                cur[i] = (src[i] + (cur[i - bpp] if i >= bpp else 0)) & 255
        elif kind == 2:
            cur = (src + prev) & 255
        elif kind == 3:
            for i in range(row_bytes):
                a = cur[i - bpp] if i >= bpp else 0
                cur[i] = (src[i] + ((a + prev[i]) >> 1)) & 255
        elif kind == 4:
            for i in range(row_bytes):
                a = cur[i - bpp] if i >= bpp else 0
                b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (src[i] + pred) & 255
        else:
            raise ValueError(f"row {r}: filter type outside 0-4")
        out[r] = cur
        prev = cur
    return out


def _chunks(data: bytes, path: str):
    """(type, body) of each chunk, CRCs checked."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: damaged {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def read_png(path: str) -> tuple[np.ndarray, set]:
    """(samples, ancillary chunk types) of a PNG: (H, W) or (H, W, C)
    samples in the file's channel order (grey, RGB or RGBA), uint8 or
    native-endian uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat, seen = None, [], set()
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind != b"IEND":
            seen.add(kind)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if interlace != 0:
        raise ValueError(f"{path}: Adam7-interlaced PNGs are not supported")
    if colour not in _CHANNELS or depth not in (8, 16) or (colour != 0 and depth != 8):
        raise ValueError(
            f"{path}: colour type {colour} at bit depth {depth} is not supported "
            "(8/16-bit grey, 8-bit RGB and RGBA are)"
        )
    if b"tRNS" in seen:
        raise ValueError(f"{path}: transparency chunks (tRNS) are not supported")
    ch = _CHANNELS[colour]
    bpp = ch * depth // 8
    rows = unfilter(np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8), h, w * bpp, bpp)
    samples = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    return samples.reshape((h, w, ch) if ch > 1 else (h, w)), seen


def imread(path: str, grayscale: bool = True, unchanged: bool = False) -> np.ndarray | None:
    """cv2.imread(path, IMREAD_GRAYSCALE) or, with `unchanged`,
    cv2.imread(path, IMREAD_UNCHANGED), bit for bit (module docstring);
    None when the file does not exist."""
    if not os.path.isfile(path):
        return None
    img, seen = read_png(path)
    if unchanged:
        return np.ascontiguousarray(img[..., [2, 1, 0, 3][: img.shape[2]]]) if img.ndim == 3 else img
    if not grayscale:
        raise ValueError("imread reads grey (grayscale=True) or the file unchanged (unchanged=True)")
    if img.ndim == 2:
        return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img
    converting = sorted(k.decode() for k in seen.intersection(_COLOUR_CONVERTING_CHUNKS))
    if converting:
        raise ValueError(
            f"{path}: colour read as grey with {converting} present, which libpng converts "
            "through gamma tables; not supported"
        )
    rgb = img[..., :3].astype(np.int32)
    cr, cg, cb = _GREY_RGB
    return ((cr * rgb[..., 0] + cg * rgb[..., 1] + cb * rgb[..., 2]) >> 15).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def imwrite(path: str, img: np.ndarray) -> None:
    """Write grey uint8 / uint16 (H, W) or BGR uint8 (H, W, 3) as a PNG,
    filter 0 on every row (what cv2.imwrite takes for the same array)."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        colour, samples = 0, img.astype(">u2") if img.dtype == np.uint16 else img
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        colour, samples = 2, img[..., ::-1]
    else:
        raise ValueError(f"imwrite takes grey u8/u16 (H, W) or BGR u8 (H, W, 3), not "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    depth = 16 if img.dtype == np.uint16 else 8
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
