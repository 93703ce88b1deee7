"""Explicit device selection: no silent fallback to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """`device` as a torch.device; raises for CUDA when no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def stream_handle(t: torch.Tensor) -> int:
    """Raw cudaStream_t of the current PyTorch stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
