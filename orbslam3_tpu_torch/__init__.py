"""PyTorch + CUDA port of the orbslam3_tpu stereo tracking path.

The JAX package `orbslam3_tpu` is the reference; this package imports
`torch` and never `jax`.  It shares the reference's jax-free host code
(Atlas, Tracking, LocalMapping, optimisers, camera models, the numpy
oracle tables) by import, and re-exports what a caller needs to drive the
port: the camera model, the pyramid parameters and the synthetic stereo
sequence with its ATE metric.

Kernels (CUDA C++ for sm_90a, ``csrc/``) build at first use into
``_build/``, never at import.
"""

from orbslam3_tpu.cameras.models import Pinhole
from orbslam3_tpu.oracle.orb_cpu import PyramidParams
from orbslam3_tpu.utils.synth import ate_rmse, stereo_sequence


def kernel_launches() -> dict[str, int]:
    """Launch counts of the hand-written kernels in this process."""
    from orbslam3_tpu_torch.ops.fast import raw_score_map
    from orbslam3_tpu_torch.ops.window_gather import gather_windows

    return {"fast_score": raw_score_map.launches, "gather_windows": gather_windows.launches}


def reset_kernel_launches() -> None:
    from orbslam3_tpu_torch.ops.fast import raw_score_map
    from orbslam3_tpu_torch.ops.window_gather import gather_windows

    raw_score_map.launches = 0
    gather_windows.launches = 0


__all__ = [
    "Pinhole", "PyramidParams", "ate_rmse", "kernel_launches",
    "reset_kernel_launches", "stereo_sequence",
]
