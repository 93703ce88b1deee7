"""PyTorch + CUDA port of orbslam3_tpu.

The JAX package `orbslam3_tpu` is the reference; this package imports
`torch` and never `jax`, nor anything of the reference package.  It
carries its own copy of the reference's JAX-free host back-end (Atlas,
Tracking, LocalMapping, LoopClosing, optimisers, vocabulary, IMU, camera
models, the numpy oracle tables, the native C++ host library,
persistence and the trajectory savers) under the same relative paths, and
re-exports what a caller needs to drive the port: the camera model, the
pyramid parameters, the fused-kernel configuration and the synthetic
stereo and RGB-D sequences with their ATE metric.

Kernels (CUDA C++ for sm_90a, ``csrc/``) and the native host library
build at first use into ``_build/``, never at import.
"""

from orbslam3_tpu_torch.cameras.models import Pinhole
from orbslam3_tpu_torch.ops.extractor import FusedKernels
from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams
from orbslam3_tpu_torch.utils.synth import ate_rmse, rgbd_sequence, stereo_sequence


def _wrappers() -> dict:
    """The counted wrapper of each hand-written kernel, by kernel name."""
    from orbslam3_tpu_torch.ops import fast_variants as fv
    from orbslam3_tpu_torch.ops.fast import detect_fused, raw_score_map
    from orbslam3_tpu_torch.ops.window_gather import gather_windows, sample_windows, window_moments

    return {
        "fast_score": raw_score_map, "gather_windows": gather_windows,
        "detect_fused": detect_fused, "window_moments": window_moments,
        "sample_windows": sample_windows,
        "fast_variant_t1": fv.fast_variant_t1, "fast_variant_t2": fv.fast_variant_t2,
        "fast_variant_t3": fv.fast_variant_t3, "fast_variant_t4": fv.fast_variant_t4,
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
