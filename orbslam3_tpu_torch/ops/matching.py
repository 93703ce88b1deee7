"""Hamming distances between 256-bit descriptors and the dense matchers
built on them.

Counterpart of ``orbslam3_tpu/ops/matching.py``'s `hamming_matrix`,
`masked_argmin`, `masked_two_best` and `search_by_projection_batch`: the
reference unpacks bits and rides the TPU's matrix unit; here the distance
is the popcount of the XOR, computed SWAR-style on 16-bit words.  All of
it ran outside any Pallas kernel in the reference, so plain tensor code is
its port; integers are exact and ties go to the first minimum.  The stereo
front-end's left-right match computes its distances on the card in K2
(``frontend/stereo_frame.stereo_pairs``, ``csrc/stereo_hamming.cu``):
`hamming_matrix` serves that kernel's twin and the dense matcher here.
"""

from __future__ import annotations

import torch

TH_LOW = 50        # ORBmatcher.h:91-93 thresholds
TH_HIGH = 100
HISTO_LENGTH = 30

# Sentinel for masked-out entries; > 256 so it never wins an argmin.
BIG = 1 << 15


def _popcount16(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of 16-bit words held non-negative in int32."""
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x & 0xFF) + (x >> 8)


def _words16(desc: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 -> (N, 16) int32 holding the 16-bit words unsigned."""
    return desc.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) int32 Hamming distances between (N, 32) uint8 blocks."""
    a, b = _words16(desc_a), _words16(desc_b)
    return _popcount16(a[:, None, :] ^ b[None, :, :]).sum(dim=-1, dtype=torch.int32)


def masked_argmin(dist: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (best index, best distance) with invalid entries pushed to
    BIG; the first minimum wins a tie, as `jnp.argmin`."""
    d = torch.where(valid, dist, BIG)
    return torch.argmin(d, dim=1).to(torch.int32), d.amin(dim=1)


def masked_two_best(
    dist: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row (best idx, best dist, second-best dist) for ratio tests."""
    d = torch.where(valid, dist, BIG)
    idx = torch.argmin(d, dim=1)
    best = d.amin(dim=1)
    # the winner column suppressed: the row's minimum over the others
    second = d.scatter(1, idx[:, None], BIG).amin(dim=1)
    return idx.to(torch.int32), best, second


# Map points per pass of `search_by_projection_batch`: bounds the (rows,
# keypoints, 16) int32 product of `hamming_matrix` (~64 MB at 1000 keypoints).
MATCH_CHUNK = 1024


def search_by_projection_batch(
    proj_uv: torch.Tensor,     # (M, 2) projected map points
    pred_level: torch.Tensor,  # (M,) predicted octave
    radius: torch.Tensor,      # (M,) per-point window radius (px)
    mp_desc: torch.Tensor,     # (M, 32) uint8 map-point descriptors
    mp_valid: torch.Tensor,    # (M,) bool
    kp_xy: torch.Tensor,       # (K, 2) frame keypoint slots
    kp_level: torch.Tensor,    # (K,)
    kp_desc: torch.Tensor,     # (K, 32)
    kp_valid: torch.Tensor,    # (K,)
    th_desc: int = TH_HIGH,
    ratio: float = 0.8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense SearchByProjection, as ``orbslam3_tpu/ops/matching.py``'s: every
    (map point, keypoint) pair is gated by the square window, the
    [pred-1, pred] octave band and descriptor distance, with the reference's
    same-level nn-ratio test.  Runs on the tensors' device, MATCH_CHUNK map
    points per pass.

    Returns (best_kp_idx (M,) int32, best_dist (M,) int32, matched (M,) bool)."""
    out = [
        _search_chunk(
            proj_uv[s : s + MATCH_CHUNK], pred_level[s : s + MATCH_CHUNK],
            radius[s : s + MATCH_CHUNK], mp_desc[s : s + MATCH_CHUNK],
            mp_valid[s : s + MATCH_CHUNK], kp_xy, kp_level, kp_desc, kp_valid,
            th_desc, ratio,
        )
        for s in range(0, max(len(proj_uv), 1), MATCH_CHUNK)
    ]
    return tuple(torch.cat(parts) for parts in zip(*out))


def _search_chunk(proj_uv, pred_level, radius, mp_desc, mp_valid,
                  kp_xy, kp_level, kp_desc, kp_valid, th_desc, ratio):
    dx = (kp_xy[None, :, 0] - proj_uv[:, None, 0]).abs()
    dy = (kp_xy[None, :, 1] - proj_uv[:, None, 1]).abs()
    in_window = (dx < radius[:, None]) & (dy < radius[:, None])
    lvl_ok = (kp_level[None, :] >= pred_level[:, None] - 1) & (
        kp_level[None, :] <= pred_level[:, None]
    )
    valid = in_window & lvl_ok & mp_valid[:, None] & kp_valid[None, :]
    dist = hamming_matrix(mp_desc, kp_desc)
    idx, best, second = masked_two_best(dist, valid)
    best_lvl = kp_level[idx]
    # nn-ratio applies only when best and runner-up share the level
    d2 = torch.where(valid, dist, BIG).scatter(1, idx[:, None].long(), BIG)
    idx2 = torch.argmin(d2, dim=1)
    same_lvl = kp_level[idx2] == best_lvl
    ratio_ok = ~same_lvl | (best.to(torch.float32) <= ratio * second.to(torch.float32))
    matched = (best <= th_desc) & ratio_ok
    return idx, best, matched
