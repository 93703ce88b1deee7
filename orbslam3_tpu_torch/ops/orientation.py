"""IC-angle keypoint orientation.

Counterpart of ``orbslam3_tpu/ops/orientation.py``: exact integer
intensity-centroid moments over the circular 31x31 patch (an int32
weighted sum of B2 windows, or the fused B4 kernel with `fused`), then f32
atan2 in degrees, shifted into [0, 360).  atan2 may differ from XLA's by
ulps (C-h2).  The windows may come gathered already (`ic_window_starts`
gives their starts), so that one B2 launch serves orientation and rBRIEF.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch.oracle.orb_cpu import HALF_PATCH_SIZE, ic_moment_weights
from orbslam3_tpu_torch.ops.window_gather import window_moments


IC_WINDOW = 2 * HALF_PATCH_SIZE + 1


def ic_window_starts(xy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(row0, col0) of the IC_WINDOW x IC_WINDOW windows around integer
    keypoint centres xy (N, 2)."""
    return xy[:, 1] - HALF_PATCH_SIZE, xy[:, 0] - HALF_PATCH_SIZE


def ic_weights(device) -> torch.Tensor:
    """(2, 31, 31) int32 (w10, w01) moment weights of the JAX package."""
    return torch.from_numpy(np.stack(ic_moment_weights()).astype(np.int32)).to(device)


def ic_angles(
    img: torch.Tensor, xy: torch.Tensor, weights: torch.Tensor | None = None,
    fused: bool = False,
) -> torch.Tensor:
    """Angles in degrees [0, 360) for integer keypoint centres xy (N, 2).

    img: the (H, W) image, or (without `fused`) the (N, 31, 31) windows at
    `ic_window_starts(xy)` gathered already."""
    if weights is None:
        weights = ic_weights(img.device)
    starts = ic_window_starts(xy) if img.dim() == 2 else (None, None)
    m10, m01 = window_moments(img, *starts, weights, fused=fused)
    ang = torch.rad2deg(torch.atan2(m01, m10))
    return torch.where(ang < 0, ang + 360.0, ang)
