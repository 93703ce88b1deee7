"""CPU golden reference for rectified-stereo left-right matching.

Semantic spec of the device matcher in ``orbslam3_tpu_torch.frontend.stereo_frame``,
re-derived from the behavior of the reference's row-bucketed Hamming search +
SAD subpixel refinement + median-distance filter
(ORB_SLAM3/src/Frame.cc:841-1011).  Deliberate, documented deviations:

 - SAD distances are exact int32 sums of absolute differences (the reference
   accumulates in float via cv::norm; integer SAD is order-independent, so the
   device path is bit-identical to this oracle);
 - the sliding-window bounds check is the *correct* one (the reference checks
   ``iniu = scaleduR0 + L - w`` which under-checks the left side — an upstream
   ORB-SLAM bug; we reject windows that would actually leave the image);
 - a flat parabola (denominator 0) yields deltaR = 0 instead of NaN/inf.
"""

from __future__ import annotations

import math

import numpy as np

TH_LOW = 50
TH_HIGH = 100
SAD_W = 5   # half window
SAD_L = 5   # half slide


def hamming(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.unpackbits(np.bitwise_xor(a, b)).sum())


def compute_stereo_matches(
    kps_l: np.ndarray,      # (N, 4): x, y, octave, angle (level-0 coords)
    desc_l: np.ndarray,     # (N, 32) uint8
    kps_r: np.ndarray,
    desc_r: np.ndarray,
    pyr_l: list[np.ndarray],
    pyr_r: list[np.ndarray],
    scale_factors: np.ndarray,
    mbf: float,
    mb: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (uRight, depth), -1 where unmatched."""
    n = len(kps_l)
    u_right = np.full(n, -1.0, np.float32)
    depth = np.full(n, -1.0, np.float32)
    th_orb = (TH_HIGH + TH_LOW) // 2
    min_d = 0.0
    max_d = mbf / mb
    inv_scale = 1.0 / scale_factors

    dist_idx = []
    for i in range(n):
        ul, vl, lvl = float(kps_l[i, 0]), float(kps_l[i, 1]), int(kps_l[i, 2])
        row = int(vl)  # truncation, as in the reference's float->index
        best_dist, best_r = TH_HIGH, -1
        for j in range(len(kps_r)):
            ur, vr, lvr = float(kps_r[j, 0]), float(kps_r[j, 1]), int(kps_r[j, 2])
            r = 2.0 * scale_factors[lvr]
            if not (math.floor(vr - r) <= row <= math.ceil(vr + r)):
                continue
            if lvr < lvl - 1 or lvr > lvl + 1:
                continue
            if not (ul - max_d <= ur <= ul - min_d):
                continue
            d = hamming(desc_l[i], desc_r[j])
            if d < best_dist:
                best_dist, best_r = d, j
        if best_dist >= th_orb or best_r < 0:
            continue

        # SAD subpixel refinement at the left keypoint's pyramid level
        inv = inv_scale[lvl]
        sul = int(round(ul * inv))
        svl = int(round(vl * inv))
        sur0 = int(round(float(kps_r[best_r, 0]) * inv))
        il_img = pyr_l[lvl].astype(np.int32)
        ir_img = pyr_r[lvl].astype(np.int32)
        h, w = ir_img.shape
        if (
            svl - SAD_W < 0 or svl + SAD_W + 1 > h
            or sul - SAD_W < 0 or sul + SAD_W + 1 > w
            or sur0 - SAD_L - SAD_W < 0 or sur0 + SAD_L + SAD_W + 1 > w
        ):
            continue
        patch_l = il_img[svl - SAD_W : svl + SAD_W + 1, sul - SAD_W : sul + SAD_W + 1]
        dists = np.empty(2 * SAD_L + 1, np.int64)
        for inc in range(-SAD_L, SAD_L + 1):
            patch_r = ir_img[
                svl - SAD_W : svl + SAD_W + 1,
                sur0 + inc - SAD_W : sur0 + inc + SAD_W + 1,
            ]
            dists[SAD_L + inc] = np.abs(patch_l - patch_r).sum()
        best_inc = int(np.argmin(dists)) - SAD_L
        if best_inc in (-SAD_L, SAD_L):
            continue
        d1 = float(dists[SAD_L + best_inc - 1])
        d2 = float(dists[SAD_L + best_inc])
        d3 = float(dists[SAD_L + best_inc + 1])
        denom = np.float32(2.0 * (d1 + d3 - 2.0 * d2))
        delta = np.float32(d1 - d3) / denom if denom != 0 else np.float32(0.0)
        if delta < -1 or delta > 1:
            continue
        best_ur = np.float32(scale_factors[lvl]) * np.float32(sur0 + best_inc + delta)
        disparity = np.float32(ul) - best_ur
        if min_d <= disparity < max_d:
            if disparity <= 0:
                disparity = np.float32(0.01)
                best_ur = np.float32(ul - 0.01)
            depth[i] = mbf / disparity
            u_right[i] = best_ur
            dist_idx.append((int(dists[SAD_L + best_inc]), i))

    if dist_idx:
        dist_idx.sort()
        median = dist_idx[len(dist_idx) // 2][0]
        th = 1.5 * 1.4 * median
        for d, i in dist_idx:
            if d >= th:
                u_right[i] = -1.0
                depth[i] = -1.0
    return u_right, depth
