"""T1-T4: the A/B variants of the threshold-free FAST score.

Counterparts of the four Pallas functions of the A/B harnesses under
``tools/`` (T1 ``bench_fast_variants.py`` `make_variant`, T2
``bench_fast_variants2.py`` `make_prod_like`, T3 ``bench_fast_variants3.py``
`make_kernel`, T4 ``bench_fast_variants4.py`` `make_kernel`).  All four
compute one function: the FAST-9/16 score minus 1 of every pixel of an
(h, w) u8 image, zero-padded outside it, as (h, w) int32 (the TPU
functions' ``[:h, :w]``; unlike B1 the 3-px border is scored, against the
zero padding).  They differ in how they reduce the 16 ring differences and
in how they cut the image; each wrapper takes its TPU function's
parameters, maps them to a `Variant` (reducer, passes, chain width, tile)
and launches the one templated kernel of ``csrc/fast_variants.cu`` on a
CUDA tensor (B1's packed core: the arcs reduced on raw ring values, the
ring differences folded out).  On a CPU tensor it runs the plain version:
the reducer written over 16 shifted ring-difference tensors, as the TPU
code writes it (16-bit chains where the TPU's are bf16; the tile does not
change the result).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch._device import stream_handle
from orbslam3_tpu_torch.oracle.orb_cpu import FAST_RING

LOGSTEP, VANHERK, PAIRS = "logstep", "vanherk", "pairs"
LANES = 128  # tile width of the TPU functions without a column chunk
# the most shared memory an H100 block can opt in to (kMaxSmem of
# csrc/fast_variants.cu), which holds the kernel's u16 halo of a tile
MAX_TILE_BYTES = 232448


def halo_bytes(rows: int, cols: int) -> int:
    """Shared bytes of the kernel's halo of a rows x cols tile: (rows + 6)
    x (cols rounded up to 4, + 8) u16 (halo_bytes of csrc/fast_variants.cu)."""
    return 2 * (rows + 6) * (4 * -(-cols // 4) + 8)


class Variant(NamedTuple):
    """What a TPU function's parameters mean on the card."""

    reducer: str   # LOGSTEP, VANHERK or PAIRS
    passes: int    # 1, or 2: the ring values loaded again for the dark polarity
    packed: bool   # 16-bit lanes (the TPU's bf16 chains), else int32
    rows: int      # tile rows (the TPU's strip, or its sub-chunk's rows)
    cols: int      # tile cols (the TPU's column chunk, else LANES)

    def check(self) -> "Variant":
        if self.rows < 1 or self.cols < 2 or self.cols % 2:
            raise ValueError(f"tile {self.rows}x{self.cols}: rows >= 1 and an even cols >= 2")
        if halo_bytes(self.rows, self.cols) > MAX_TILE_BYTES:
            raise ValueError(
                f"tile {self.rows}x{self.cols}: its halo exceeds {MAX_TILE_BYTES} B of shared memory"
            )
        return self


_IN_KIND = {None: 0, torch.int32: 1, torch.bfloat16: 2}


def t1_variant(cast_early: bool, chain_dtype=None, in_dtype=None) -> Variant:
    """`make_variant(cast_early, chain_dtype, in_dtype)`: log-step, strip
    32.  `chain_dtype` None or torch.bfloat16, `in_dtype` None, torch.int32
    or torch.bfloat16 (the TPU's jnp dtypes).  The chains are 16-bit where
    they are bf16 on the TPU: bf16 chains, or bf16 views cast early."""
    if chain_dtype not in (None, torch.bfloat16) or in_dtype not in _IN_KIND:
        raise ValueError(f"unsupported dtypes: chain {chain_dtype}, in {in_dtype}")
    packed = chain_dtype is torch.bfloat16 or (bool(cast_early) and in_dtype is torch.bfloat16)
    return Variant(LOGSTEP, 1, packed, 32, LANES).check()


def t2_variant(strip: int, arc: str = LOGSTEP, chunk: tuple | None = None) -> Variant:
    """`make_prod_like(strip, arc, chunk)`: bf16, `arc` LOGSTEP or VANHERK,
    `chunk` None or (rows, cols)."""
    if arc not in (LOGSTEP, VANHERK):
        raise ValueError(f"arc must be {LOGSTEP!r} or {VANHERK!r}, got {arc!r}")
    rows, cols = (int(strip), LANES) if chunk is None else (int(chunk[0]), int(chunk[1]))
    return Variant(arc, 1, True, rows, cols).check()


def t3_variant(strip: int = 48, chunk: int = 384, mode: str = "twopass") -> Variant:
    """`make_kernel(strip, chunk, mode)` of T3: bf16, van Herk, `mode`
    "twopass" or "onepass"."""
    if mode not in ("twopass", "onepass"):
        raise ValueError(f"mode must be 'twopass' or 'onepass', got {mode!r}")
    return Variant(VANHERK, 2 if mode == "twopass" else 1, True, int(strip), int(chunk)).check()


def t4_variant(strip: int = 48, chunk: int = 384, win: str = VANHERK) -> Variant:
    """`make_kernel(strip, chunk, win)` of T4: bf16, `win` VANHERK (`_win9`)
    or PAIRS (`_win9_pairs`)."""
    if win not in (VANHERK, PAIRS):
        raise ValueError(f"win must be {VANHERK!r} or {PAIRS!r}, got {win!r}")
    return Variant(win, 1, True, int(strip), int(chunk)).check()


# --- the plain version -------------------------------------------------------
def _ring_diffs(img: torch.Tensor, dtype: torch.dtype) -> list:
    """The 16 ring-difference planes of the zero-padded image."""
    h, w = img.shape
    pad = torch.nn.functional.pad(img.to(dtype), (3, 3, 3, 3))
    c = pad[3 : 3 + h, 3 : 3 + w]
    return [pad[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] - c for dx, dy in FAST_RING.tolist()]


def _arc_logstep(p: list) -> torch.Tensor:
    """tools/bench_fast_variants.py:81-89: log-step circular window-9 min,
    max over the 16 windows."""
    m2 = [torch.minimum(p[o], p[(o + 1) % 16]) for o in range(16)]
    m4 = [torch.minimum(m2[o], m2[(o + 2) % 16]) for o in range(16)]
    m8 = [torch.minimum(m4[o], m4[(o + 4) % 16]) for o in range(16)]
    m9 = [torch.minimum(m8[o], p[(o + 8) % 16]) for o in range(16)]
    return functools.reduce(torch.maximum, m9)


def _win9(p: list, op) -> list:
    """orbslam3_tpu/ops/fast.py:62: van Herk window-9 `op` over the circular
    16-sequence (extended to 24, blocks of 9)."""
    e = [p[j % 16] for j in range(24)]
    pre = [None] * 24
    for j in range(24):
        pre[j] = e[j] if j % 9 == 0 else op(pre[j - 1], e[j])
    suf = [None] * 24
    for j in reversed(range(24)):
        suf[j] = e[j] if (j % 9 == 8 or j == 23) else op(suf[j + 1], e[j])
    return [op(suf[o], pre[o + 8]) for o in range(16)]


def _win9_pairs(p: list, op) -> list:
    """tools/bench_fast_variants4.py:35: window-9 `op` by log-step doubling."""
    e = [p[j % 16] for j in range(24)]
    w2 = [op(e[j], e[j + 1]) for j in range(23)]
    w4 = [op(w2[j], w2[j + 2]) for j in range(21)]
    w8 = [op(w4[j], w4[j + 4]) for j in range(17)]
    return [op(w8[o], e[o + 8]) for o in range(16)]


def score_plain(img: torch.Tensor, variant: Variant) -> torch.Tensor:
    """(h, w) int32 zero-padded FAST score - 1 of `img`, reduced as `variant`
    says (its tile does not change the result)."""
    dtype = torch.int16 if variant.packed else torch.int32
    d = _ring_diffs(img, dtype)
    if variant.reducer == LOGSTEP:
        s = torch.maximum(_arc_logstep(d), _arc_logstep([-x for x in d]))
    else:
        win = _win9_pairs if variant.reducer == PAIRS else _win9
        bright = functools.reduce(torch.maximum, win(d, torch.minimum))
        if variant.passes == 2:
            d = _ring_diffs(img, dtype)
        ndark = functools.reduce(torch.minimum, win(d, torch.maximum))
        s = torch.maximum(bright, -ndark)
    return s.to(torch.int32) - 1


def fast_variant_t1_plain(img, cast_early, chain_dtype=None, in_dtype=None):
    return score_plain(img, t1_variant(cast_early, chain_dtype, in_dtype))


def fast_variant_t2_plain(img, strip, arc=LOGSTEP, chunk=None):
    return score_plain(img, t2_variant(strip, arc, chunk))


def fast_variant_t3_plain(img, strip=48, chunk=384, mode="twopass"):
    return score_plain(img, t3_variant(strip, chunk, mode))


def fast_variant_t4_plain(img, strip=48, chunk=384, win=VANHERK):
    return score_plain(img, t4_variant(strip, chunk, win))


# --- the wrappers ------------------------------------------------------------
def _check_image(img: torch.Tensor) -> None:
    if img.dim() != 2 or img.dtype != torch.uint8:
        raise TypeError(f"img must be a 2-D uint8 tensor, got {img.dtype} {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("img must be contiguous")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {img.device}")


def _launch(wrapper, name: str, img: torch.Tensor, *args: int) -> torch.Tensor:
    h, w = img.shape
    out = torch.empty((h, w), dtype=torch.int32, device=img.device)
    err = getattr(_build.kernels(), name)(
        img.data_ptr(), out.data_ptr(), h, w, *args, stream_handle(img)
    )
    _build.check_launch(name, err)
    wrapper.launches += 1
    return out


def fast_variant_t1(img: torch.Tensor, cast_early: bool, chain_dtype=None, in_dtype=None):
    """T1, `make_variant(cast_early, chain_dtype, in_dtype)(img)[:h, :w]`.
    CUDA tensor: the kernel; CPU tensor: the plain version."""
    _check_image(img)
    t1_variant(cast_early, chain_dtype, in_dtype)
    if img.device.type == "cpu":
        return fast_variant_t1_plain(img, cast_early, chain_dtype, in_dtype)
    return _launch(
        fast_variant_t1, "fast_variant_t1", img, int(bool(cast_early)),
        int(chain_dtype is torch.bfloat16), _IN_KIND[in_dtype],
    )


def fast_variant_t2(img: torch.Tensor, strip: int, arc: str = LOGSTEP, chunk: tuple | None = None):
    """T2, `make_prod_like(strip, arc, chunk)(img)[:h, :w]`."""
    _check_image(img)
    t2_variant(strip, arc, chunk)
    if img.device.type == "cpu":
        return fast_variant_t2_plain(img, strip, arc, chunk)
    rows, cols = (0, 0) if chunk is None else chunk
    return _launch(
        fast_variant_t2, "fast_variant_t2", img, int(strip), int(arc == VANHERK), int(rows), int(cols)
    )


def fast_variant_t3(img: torch.Tensor, strip: int = 48, chunk: int = 384, mode: str = "twopass"):
    """T3, `make_kernel(strip, chunk, mode)(img)[:h, :w]`."""
    _check_image(img)
    t3_variant(strip, chunk, mode)
    if img.device.type == "cpu":
        return fast_variant_t3_plain(img, strip, chunk, mode)
    return _launch(
        fast_variant_t3, "fast_variant_t3", img, int(strip), int(chunk), int(mode == "twopass")
    )


def fast_variant_t4(img: torch.Tensor, strip: int = 48, chunk: int = 384, win: str = VANHERK):
    """T4, `make_kernel(strip, chunk, win)(img)[:h, :w]`."""
    _check_image(img)
    t4_variant(strip, chunk, win)
    if img.device.type == "cpu":
        return fast_variant_t4_plain(img, strip, chunk, win)
    return _launch(fast_variant_t4, "fast_variant_t4", img, int(strip), int(chunk), int(win == PAIRS))


for _fn in (fast_variant_t1, fast_variant_t2, fast_variant_t3, fast_variant_t4):
    _fn.launches = 0
