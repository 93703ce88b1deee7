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
from orbslam3_tpu_torch.utils.launches import reset as reset_kernel_launches
from orbslam3_tpu_torch.utils.launches import snapshot as kernel_launches
from orbslam3_tpu_torch.utils.synth import ate_rmse, rgbd_sequence, stereo_sequence


__all__ = [
    "FusedKernels", "Pinhole", "PyramidParams", "ate_rmse", "kernel_launches",
    "reset_kernel_launches", "rgbd_sequence", "stereo_sequence",
]
