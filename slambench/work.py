"""The least work of one stereo frame's front-end, stage by stage, and the
card's peaks it is held against.

Every count depends only on the image's shape and the ORB settings, never
on what a kernel does, so a stage keeps its count whatever implements it
(a torch op, a hand-written kernel or several fused into one).  Bytes are
each input byte read once and each output byte written once; operations
are two-input operations of the type named.  Where the work depends on the
data (the candidate pairs of the stereo match, the SAD slides of the
tentative matches) it counts none of it, so the sum stays a least time.
"""

from __future__ import annotations

# NVIDIA H100 SXM at 700 W, the data sheet's rates: HBM3 3.35 TB/s; int32
# 132 SMs x 64 lanes x 1.98 GHz x 2 (IMAD / IADD3 / VIMNMX3 each do two
# two-input operations); 16-bit lanes two to a register, twice that; f32
# outside the tensor cores with each product and sum issued on its own.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 2 * 132 * 64 * 1.98e9
INT16X2_OPS_PER_S = 2 * INT32_OPS_PER_S
F32_OPS_PER_S = 132 * 128 * 1.98e9

EDGE_THRESHOLD = 19
FAST_BORDER = EDGE_THRESHOLD - 3
# FAST-9/16 score per pixel: van Herk arc extremes over the raw ring
# values, both polarities, and the fold (the port's count, 118)
FAST_OPS_PER_PX = 2 * (2 * (7 + 6) + 16 + 15) + 4
IC_PATCH_PX = 721      # pixels of the 31-px circular patch (umax rows)
BLUR_TAPS = 7
BRIEF_PAIRS = 256
PACK_COLS = 40


def level_sizes(h: int, w: int, n_levels: int, scale_factor: float) -> list:
    """(h, w) of each level: round half to even of dim / scale**l."""
    return [(round(h / scale_factor**l), round(w / scale_factor**l)) for l in range(n_levels)]


def stages(h: int, w: int, n_features: int, n_levels: int, scale_factor: float) -> dict:
    """{stage: (bytes, [(ops, ops_per_s)])} of one stereo pair."""
    sizes = level_sizes(h, w, n_levels, scale_factor)
    area = sum(a * b for a, b in sizes)
    crop = sum(max(a - 2 * FAST_BORDER, 0) * max(b - 2 * FAST_BORDER, 0) for a, b in sizes)
    k = 2 * n_features  # keypoints of both cameras
    return {
        # read level 0, write levels 1.. ; two taps each way, a multiply-add a tap
        "pyramid": (2 * area, [(2 * (area - h * w) * 4 * 2, INT32_OPS_PER_S)]),
        # read every detection crop once
        "fast": (2 * crop, [(2 * crop * FAST_OPS_PER_PX, INT16X2_OPS_PER_S)]),
        # the kept keypoints written: x, y, response
        "select": (k * 12, []),
        # intensity centroid: two multiply-adds a patch pixel; the angle out
        "orientation": (k * 4, [(k * IC_PATCH_PX * 2 * 2, INT32_OPS_PER_S)]),
        # the sampling image: read and write every level, 7 taps each way
        "blur": (2 * 2 * area, [(2 * area * 2 * BLUR_TAPS * 2, INT32_OPS_PER_S)]),
        # rotate 512 points (4 products, 2 sums), 256 compares; 32 bytes out
        "brief": (k * 32, [(k * 512 * 6, F32_OPS_PER_S), (k * BRIEF_PAIRS, INT32_OPS_PER_S)]),
        # each descriptor read once; u_right and depth of the left slots out
        "stereo_match": (k * 32 + n_features * 8, []),
        # the packed block
        "pack": (n_features * PACK_COLS * 4, []),
    }


def least_seconds(h: int, w: int, n_features: int, n_levels: int, scale_factor: float) -> float:
    """The least time of one stereo frame's front-end on the card: per
    stage the larger of its bytes over the memory rate and its operations
    over their rates, summed over the stages."""
    total = 0.0
    for n_bytes, ops in stages(h, w, n_features, n_levels, scale_factor).values():
        total += max([n_bytes / HBM_BYTES_PER_S] + [n / rate for n, rate in ops])
    return total

