"""PyTorch + CUDA port of the orbslam3_tpu tracking front-ends.

The JAX package `orbslam3_tpu` is the reference; this package imports
`torch` and never `jax`.  It shares the reference's jax-free host code
(Atlas, Tracking, LocalMapping, optimisers, camera models, the numpy
oracle tables) by import, and re-exports what a caller needs to drive the
port: the camera model, the pyramid parameters, the fused-kernel
configuration and the synthetic stereo and RGB-D sequences with their ATE
metric.

Kernels (CUDA C++ for sm_90a, ``csrc/``) build at first use into
``_build/``, never at import.
"""

from orbslam3_tpu.cameras.models import Pinhole
from orbslam3_tpu.oracle.orb_cpu import PyramidParams
from orbslam3_tpu.utils.synth import ate_rmse, rgbd_sequence, stereo_sequence
from orbslam3_tpu_torch.ops.extractor import FusedKernels


def _wrappers() -> dict:
    """The counted wrapper of each hand-written kernel, by kernel name."""
    from orbslam3_tpu_torch.ops.fast import detect_fused, raw_score_map
    from orbslam3_tpu_torch.ops.window_gather import gather_windows, sample_windows, window_moments

    return {
        "fast_score": raw_score_map, "gather_windows": gather_windows,
        "detect_fused": detect_fused, "window_moments": window_moments,
        "sample_windows": sample_windows,
    }


def kernel_launches() -> dict[str, int]:
    """Launch counts of the hand-written kernels in this process (one per
    wrapper call that launched its kernel)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_kernel_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


__all__ = [
    "FusedKernels", "Pinhole", "PyramidParams", "ate_rmse", "kernel_launches",
    "reset_kernel_launches", "rgbd_sequence", "stereo_sequence",
]
