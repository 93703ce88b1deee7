"""Images and thresholds that take the FAST score to the ends of its range.

The score (max over the 16 circular 9-arcs of the min ring difference,
either polarity, minus 1) lies in [-128, 254]: 254 at a lone spot on a flat
ground (every ring difference +-255), -1 on a flat image, about -128 inside
a ring that alternates 0/255 around a centre of 128 (every arc holds both).
B1 and B3 run a packed 16-bit core that folds the ring differences into the
arc reductions (csrc/fast_score.cuh), and B3 keeps its tile-selected map in
int16; `tests/test_torch_score_core.py` (CPU) and `chip_smoke.py` (card)
hold both kernels against their plain versions on these inputs.  Odd widths
leave a partial 4-pixel group.  Numpy only.
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.oracle.orb_cpu import FAST_RING


def checker(h: int, w: int) -> np.ndarray:
    return ((np.add.outer(np.arange(h), np.arange(w)) % 2) * 255).astype(np.uint8)


def spots(h: int, w: int, bright: bool) -> np.ndarray:
    """Two lone spots, 255 on 0 (bright) or 0 on 255: score 254 at each."""
    img = np.full((h, w), 0 if bright else 255, np.uint8)
    img[h // 2, w // 2] = img[5, 7] = 255 if bright else 0
    return img


def alternating_ring(h: int, w: int) -> np.ndarray:
    """Rings alternating 0/255 around centres of 128: score about -128."""
    img = np.full((h, w), 128, np.uint8)
    for y in range(h // 2 - 6, h // 2 + 7, 13):
        for x in range(5, w - 5, 11):
            for k, (dx, dy) in enumerate(FAST_RING.tolist()):
                img[y + dy, x + dx] = 255 * (k % 2)
    return img


def seam_mask(h: int, w: int) -> np.ndarray:
    """The 3-px frame's inside, less a column seam and a row seam, as the
    detection composite's mask has between its levels."""
    mask = np.zeros((h, w), bool)
    mask[3 : h - 3, 3 : w - 3] = True
    mask[:, w // 3 : w // 3 + 5] = False
    mask[h // 2 + 1 : h // 2 + 4, :] = False
    return mask


def score_images() -> dict:
    """name -> (h, w) u8 image for B1 and the score core."""
    return {
        "flat0": np.zeros((29, 45), np.uint8),
        "flat255": np.full((29, 45), 255, np.uint8),
        "checker": checker(33, 67),
        "bright_spots": spots(31, 41, True),
        "dark_spots": spots(31, 41, False),
        "alternating_ring": alternating_ring(40, 61),
        "random_97x211": np.random.default_rng(3).integers(0, 256, (97, 211), np.uint8),
        "random_64x260": np.random.default_rng(4).integers(0, 256, (64, 260), np.uint8),
    }


# B3 at thresholds at and beyond the ends of the score's range, (image
# kind, ini_th, min_th): min_th <= 0 keeps zero and negative scores in the
# retry map, ini_th > 254 sends every tile to its retry
B3_THRESHOLDS = [
    ("random", 20, 0),
    ("random", 20, -5),
    ("random", 255, 7),
    ("random", 300, -300),
    ("ring", 20, -200),
    ("checker", 255, 0),
]


def b3_case(kind: str, seed: int = 11, h: int = 64, w: int = 96) -> tuple:
    """(comp, mask) of B3 for one image kind of B3_THRESHOLDS; sides are
    multiples of 32."""
    if kind == "checker":
        comp = checker(h, w)
    elif kind == "ring":
        comp = alternating_ring(h, w)
    else:
        comp = np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)
    mask = np.zeros((h, w), bool)
    mask[3 : h - 3, 3 : w - 3] = True
    return comp, mask
