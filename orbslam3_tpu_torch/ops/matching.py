"""Hamming distances between 256-bit descriptors.

Counterpart of ``orbslam3_tpu/ops/matching.py``'s `hamming_matrix`: the
reference unpacks bits and rides the TPU's matrix unit; here it is the
popcount of the XOR, computed SWAR-style on 16-bit words.  It ran outside
any Pallas kernel in the reference, so plain tensor code is its port.
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
