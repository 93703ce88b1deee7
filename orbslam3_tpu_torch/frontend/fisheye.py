"""Fisheye (KannalaBrandt8) stereo front-end.

Counterpart of ``orbslam3_tpu/frontend/fisheye.py``, the fisheye stereo
pipeline of ORB-SLAM3 — the Frame fisheye ctor
(ORB_SLAM3/src/Frame.cc:1089-1135) and ComputeStereoFishEyeMatches
(:1156-1191): each camera extracts independently with a lapping area
(keypoints inside the overlap are packed at the tail by the extractor,
ORBextractor.cc:1261-1303 / `split_lapping`); overlap descriptors are
brute-force kNN-matched (k=2, ratio 0.7 — the reference uses
cv::BFMatcher) and matches are triangulated with
KannalaBrandt8::TriangulateMatches, keeping pairs with positive depth and
bounded reprojection error.

Both cameras run through the stereo front-end on one torch device
(`StereoFrontEnd.pair_block`: one detection pass over both cameras' crops,
one B2 launch for both cameras' orientation and BRIEF windows, or B3, B4
and B5's rBRIEF mode under `FusedKernels`; on CUDA one replay of the
front-end's pair-block graph).  The rectified left-right
matcher is not run: the reference runs it and drops its `u_right` /
`depth`, so nothing returned here depends on it.  The two cameras' blocks
reach the host as one (2, K, 40) array in one copy; the lapping split,
the kNN matching and the triangulation are host numpy, as in the
reference.

The dual-camera observation model mirrors the reference Frame's
Nleft/Nright layout (ORB_SLAM3/include/Frame.h:329-334): the SLAM frame
carries BOTH cameras' keypoints concatenated (left block first),
`left_to_right`/`right_to_left` match indices, and the triangulated
left-camera-frame stereo points (mvStereo3Dpoints role).
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch import native
from orbslam3_tpu_torch._device import resolve_device
from orbslam3_tpu_torch.frontend.stereo_frame import DEFAULT_FX, DEFAULT_MBF, front_end
from orbslam3_tpu_torch.ops.extractor import FusedKernels, split_lapping
from orbslam3_tpu_torch.utils.lie import SE3


def split_pair_block(block: np.ndarray, lapping_l, lapping_r) -> tuple[dict, dict]:
    """Host side of `extract_fisheye_pair`: each camera's valid keypoints,
    mono first and the lapping area's at the tail (`split_lapping`)."""
    feats = []
    for side, lap in zip(block, (lapping_l, lapping_r)):
        d = dict(
            xy=side[:, 0:2],
            response=side[:, 2],
            angle=side[:, 3],
            octave=side[:, 4].astype(np.int32),
            valid=side[:, 5] > 0.5,
            desc=side[:, 8:40].astype(np.uint8),
        )
        order, mono_idx = split_lapping(d, lap)
        feats.append(
            dict(
                kps=d["xy"][order],
                octave=d["octave"][order],
                angle=d["angle"][order],
                response=d["response"][order],
                desc=d["desc"][order],
                mono_index=mono_idx,
            )
        )
    return feats[0], feats[1]


def extract_fisheye_pair(
    img_l, img_r, params, lapping_l, lapping_r, *,
    device: str | torch.device = "cuda", fused: FusedKernels = FusedKernels(),
):
    """Extraction for both fisheye cameras on `device` + lapping split.

    Returns (featL, featR) dicts with keys kps/octave/angle/response/desc
    plus `mono_index` — keypoints [mono_index:] lie inside the lapping area.
    """
    dev = resolve_device(device)
    pair = torch.from_numpy(np.ascontiguousarray(np.stack([img_l, img_r]))).to(dev)
    fe = front_end(params, tuple(pair.shape[1:]), DEFAULT_MBF, DEFAULT_FX, str(dev), fused)
    return split_pair_block(fe.pair_block(pair).cpu().numpy(), lapping_l, lapping_r)


def compute_stereo_fisheye_matches(
    feat_l: dict,
    feat_r: dict,
    cam_l,
    cam_r,
    T_lr: SE3,
    level_sigma2: np.ndarray,
    ratio: float = 0.7,
    depth_min: float = 1e-4,
):
    """kNN + ratio matching over the lapping-area descriptors, then KB8
    two-view triangulation (ComputeStereoFishEyeMatches,
    ORB_SLAM3/src/Frame.cc:1156-1191).  Returns
    (depth_l (Nl,), l2r (Nl,), r2l (Nr,), p3d_l (Nl, 3)): per-left-keypoint
    depth (<0 unmatched), left<->right match indices (-1 unmatched;
    mvLeftToRightMatch/mvRightToLeftMatch role), and the triangulated point
    in the LEFT camera frame for matched left keypoints (mvStereo3Dpoints
    role; rows for unmatched keypoints are zero)."""
    ml, mr = feat_l["mono_index"], feat_r["mono_index"]
    dl = feat_l["desc"][ml:]
    dr = feat_r["desc"][mr:]
    n_l = len(feat_l["kps"])
    n_r = len(feat_r["kps"])
    depth = np.full(n_l, -1.0)
    l2r = np.full(n_l, -1, np.int64)
    r2l = np.full(n_r, -1, np.int64)
    p3d_l = np.zeros((n_l, 3))
    if len(dl) == 0 or len(dr) == 0:
        return depth, l2r, r2l, p3d_l
    idx, dist = native.hamming_knn(dl, dr, k=2)
    ok = (dist[:, 0] >= 0) & (
        (dist[:, 1] < 0) | (dist[:, 0] < ratio * np.maximum(dist[:, 1], 1))
    )
    cand_l = np.nonzero(ok)[0]
    if len(cand_l) == 0:
        return depth, l2r, r2l, p3d_l
    cand_r = idx[cand_l, 0]
    kp_l = feat_l["kps"][ml:][cand_l]
    kp_r = feat_r["kps"][mr:][cand_r]
    s2_l = level_sigma2[feat_l["octave"][ml:][cand_l]]
    s2_r = level_sigma2[feat_r["octave"][mr:][cand_r]]
    p3d, z = cam_l.triangulate_matches(cam_r, kp_l, kp_r, s2_l, s2_r, T_lr)
    good = z > depth_min
    for k in np.nonzero(good)[0]:
        i_l = ml + int(cand_l[k])
        i_r = mr + int(cand_r[k])
        if r2l[i_r] >= 0:
            continue  # first-come claims the right keypoint
        depth[i_l] = z[k]
        l2r[i_l] = i_r
        r2l[i_r] = i_l
        p3d_l[i_l] = p3d[k]
    return depth, l2r, r2l, p3d_l
