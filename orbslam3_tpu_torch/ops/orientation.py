"""IC-angle keypoint orientation.

Counterpart of ``orbslam3_tpu/ops/orientation.py``: exact integer
intensity-centroid moments over the circular 31x31 patch (B2 gather + an
int32 weighted sum, or the fused B4 kernel with `fused`), then f32 atan2
in degrees, shifted into [0, 360).  atan2 may differ from XLA's by ulps
(C-h2).
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch.oracle.orb_cpu import HALF_PATCH_SIZE, ic_moment_weights
from orbslam3_tpu_torch.ops.window_gather import window_moments


def ic_weights(device) -> torch.Tensor:
    """(2, 31, 31) int32 (w10, w01) moment weights of the JAX package."""
    return torch.from_numpy(np.stack(ic_moment_weights()).astype(np.int32)).to(device)


def ic_angles(
    img: torch.Tensor, xy: torch.Tensor, weights: torch.Tensor | None = None,
    fused: bool = False,
) -> torch.Tensor:
    """Angles in degrees [0, 360) for integer keypoint centres xy (N, 2)."""
    if weights is None:
        weights = ic_weights(img.device)
    m10, m01 = window_moments(
        img, xy[:, 1] - HALF_PATCH_SIZE, xy[:, 0] - HALF_PATCH_SIZE, weights, fused=fused
    )
    ang = torch.rad2deg(torch.atan2(m01, m10))
    return torch.where(ang < 0, ang + 360.0, ang)
