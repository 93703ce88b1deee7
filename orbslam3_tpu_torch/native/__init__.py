"""ctypes bindings for the native host-runtime library.

Compiles orbslam3_native.cpp with g++ on first use into the package's
_build/ (named by a hash of the source); every entry point has a
pure-NumPy fallback so the package works without a toolchain.
`available()` reports which path is active.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from orbslam3_tpu_torch._build import host_library

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "src", "orbslam3_native.cpp")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = host_library(_SRC, "liborbslam3_native", ".so", _FLAGS)
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.distribute_octree.restype = ctypes.c_int
    lib.distribute_octree.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.hamming_knn.restype = None
    lib.hamming_knn.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.hamming_matrix.restype = None
    lib.hamming_matrix.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.project_match_local.restype = ctypes.c_int
    lib.project_match_local.argtypes = [
        ctypes.POINTER(ctypes.c_float),    # proj (M, 5)
        ctypes.POINTER(ctypes.c_uint8),    # mp_desc (M, 32)
        ctypes.POINTER(ctypes.c_uint8),    # mp_obs (M,)
        ctypes.c_int,                      # m
        ctypes.POINTER(ctypes.c_float),    # kp_xy (K, 2)
        ctypes.POINTER(ctypes.c_int32),    # kp_level (K,)
        ctypes.POINTER(ctypes.c_uint8),    # kp_desc (K, 32)
        ctypes.POINTER(ctypes.c_float),    # kp_ur (K,)
        ctypes.POINTER(ctypes.c_uint8),    # occupied (K,) in/out
        ctypes.c_int,                      # k
        ctypes.POINTER(ctypes.c_float),    # scale_factors
        ctypes.c_int,                      # n_levels
        ctypes.c_float, ctypes.c_float, ctypes.c_int,   # th, ratio, match_th
        ctypes.c_float, ctypes.c_float,    # min_x, min_y
        ctypes.c_float, ctypes.c_float,    # grid_w, grid_h
        ctypes.POINTER(ctypes.c_int32),    # out_idx (M,)
    ]
    lib.project_match_last.restype = ctypes.c_int
    lib.project_match_last.argtypes = [
        ctypes.POINTER(ctypes.c_double),   # pw (M, 3)
        ctypes.POINTER(ctypes.c_uint8),    # mp_desc
        ctypes.POINTER(ctypes.c_int32),    # mp_oct
        ctypes.POINTER(ctypes.c_uint8),    # mp_valid
        ctypes.POINTER(ctypes.c_uint8),    # mp_obs
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double,                   # mbf
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.distinctive_select.restype = None
    lib.distinctive_select.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),    # descs (N, 32) group-ordered
        ctypes.POINTER(ctypes.c_int32),    # group_off (G+1,)
        ctypes.c_int,                      # g_count
        ctypes.POINTER(ctypes.c_int32),    # out_row (G,)
    ]
    lib.pose_optimize.restype = ctypes.c_int
    lib.pose_optimize.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int,
    ]
    lib.ba_schur.restype = ctypes.c_int
    lib.ba_schur.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8),   # abort flag (nullable)
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
def distribute_octree(kps: np.ndarray, min_x: int, max_x: int, min_y: int,
                      max_y: int, target: int) -> np.ndarray:
    """Exact quadtree keypoint spreading; kps (N, 3) = (x, y, response) in
    crop coords.  Returns selected row indices."""
    lib = _load()
    kps = np.ascontiguousarray(kps, np.float32)
    n = len(kps)
    if n == 0:
        return np.empty(0, np.int64)
    if lib is not None:
        out = np.empty(n, np.int32)
        m = lib.distribute_octree(
            kps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            int(min_x), int(max_x), int(min_y), int(max_y), int(target),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out[:m].astype(np.int64)
    # fallback: oracle implementation (returns keypoints, map back to indices)
    from orbslam3_tpu_torch.oracle.orb_cpu import distribute_octree as py_oct

    sel = py_oct(kps.astype(np.float64), min_x, max_x, min_y, max_y, target)
    idx = []
    used = set()
    for row in sel:
        cand = np.nonzero(
            (kps[:, 0] == row[0]) & (kps[:, 1] == row[1]) & (kps[:, 2] == row[2])
        )[0]
        for c in cand:
            if int(c) not in used:
                used.add(int(c))
                idx.append(int(c))
                break
    return np.asarray(idx, np.int64)


def distinctive_select(descs: np.ndarray, group_off: np.ndarray):
    """Per-group min-median-Hamming representative row, or None when the
    native library is unavailable (caller falls back to the NumPy path).

    descs (N, 32) uint8 group-ordered; group_off (G+1,) int32 offsets.
    Returns (G,) int32 global row indices (-1 for empty groups)."""
    lib = _load()
    if lib is None:
        return None
    descs = np.ascontiguousarray(descs, np.uint8)
    group_off = np.ascontiguousarray(group_off, np.int32)
    g = len(group_off) - 1
    out = np.empty(g, np.int32)
    if g > 0:
        lib.distinctive_select(
            descs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            group_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            g,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    return out


def hamming_knn(a: np.ndarray, b: np.ndarray, k: int = 2):
    """(idx (Na, k) int32, dist (Na, k) int32) nearest-neighbors in B."""
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    lib = _load()
    if lib is not None and len(a) and len(b):
        idx = np.empty((len(a), k), np.int32)
        dist = np.empty((len(a), k), np.int32)
        lib.hamming_knn(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(a),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(b), k,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            dist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return idx, dist
    from orbslam3_tpu_torch.slam.matchers import hamming_matrix_np

    d = hamming_matrix_np(a, b)
    k_eff = min(k, d.shape[1])
    idx = np.argsort(d, axis=1, kind="stable")[:, :k_eff].astype(np.int32)
    dist = np.take_along_axis(d, idx, axis=1).astype(np.int32)
    if k_eff < k:
        pad_i = np.full((len(a), k - k_eff), -1, np.int32)
        pad_d = np.full((len(a), k - k_eff), -1, np.int32)
        idx = np.concatenate([idx, pad_i], axis=1)
        dist = np.concatenate([dist, pad_d], axis=1)
    return idx, dist


def hamming_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    lib = _load()
    if lib is not None and len(a) and len(b):
        out = np.empty((len(a), len(b)), np.int32)
        lib.hamming_matrix(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(a),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(b),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out
    from orbslam3_tpu_torch.slam.matchers import hamming_matrix_np

    return hamming_matrix_np(a, b)


def project_match_local(proj, mp_desc, mp_obs, kp_xy, kp_level, kp_desc,
                        kp_ur, occupied, scale_factors, th, ratio, match_th,
                        min_x, min_y, grid_w, grid_h):
    """Native TrackLocalMap projection matcher (see orbslam3_native.cpp).

    Returns (out_idx (M,) int32 frame slot or -1, n_matched) and mutates
    `occupied` in place.  None when the native lib is unavailable (caller
    falls back to the Python walk)."""
    lib = _load()
    if lib is None:
        return None
    proj = np.ascontiguousarray(proj, np.float32)
    mp_desc = np.ascontiguousarray(mp_desc, np.uint8)
    mp_obs = np.ascontiguousarray(mp_obs, np.uint8)
    kp_xy = np.ascontiguousarray(kp_xy, np.float32)
    kp_level = np.ascontiguousarray(kp_level, np.int32)
    kp_desc = np.ascontiguousarray(kp_desc, np.uint8)
    kp_ur = np.ascontiguousarray(kp_ur, np.float32)
    occupied = np.ascontiguousarray(occupied, np.uint8)
    sf = np.ascontiguousarray(scale_factors, np.float32)
    m = len(proj)
    out = np.empty(m, np.int32)
    n = lib.project_match_local(
        proj.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mp_desc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        mp_obs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), m,
        kp_xy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        kp_level.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        kp_desc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        kp_ur.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        occupied.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(kp_xy),
        sf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(sf),
        float(th), float(ratio), int(match_th),
        float(min_x), float(min_y), float(grid_w), float(grid_h),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out, n


def pose_optimize(pw, uv, ur, inv_sigma2, fx, fy, cx, cy, mbf, R, t,
                  n_rounds=4, n_iters=10):
    """Native motion-only pose optimization (see orbslam3_native.cpp).

    Returns (R (3,3), t (3,), inlier (n,) bool, n_inliers) or None when the
    native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pw = np.ascontiguousarray(pw, np.float64)
    uv = np.ascontiguousarray(uv, np.float64)
    ur = np.ascontiguousarray(ur, np.float64)
    is2 = np.ascontiguousarray(inv_sigma2, np.float64)
    Rb = np.ascontiguousarray(R, np.float64).copy()
    tb = np.ascontiguousarray(t, np.float64).copy()
    n = len(pw)
    inlier = np.empty(n, np.uint8)
    n_in = lib.pose_optimize(
        pw.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        uv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ur.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        is2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        float(fx), float(fy), float(cx), float(cy), float(mbf),
        Rb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        tb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        inlier.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(n_rounds), int(n_iters),
    )
    return Rb, tb, inlier.astype(bool), int(n_in)


def project_match_last(pw, mp_desc, mp_oct, mp_valid, mp_obs,
                       Rcw, tcw, fx, fy, cx, cy, mbf,
                       min_x, max_x, min_y, max_y,
                       kp_xy, kp_level, kp_desc, kp_ur, occupied,
                       scale_factors, th, match_th, same_octave_first,
                       forward, backward, grid_min_x, grid_min_y,
                       grid_w, grid_h):
    """Native motion-model matcher; returns (out_idx (M,) int32, n) or None."""
    lib = _load()
    if lib is None:
        return None
    pw = np.ascontiguousarray(pw, np.float64)
    mp_desc = np.ascontiguousarray(mp_desc, np.uint8)
    mp_oct = np.ascontiguousarray(mp_oct, np.int32)
    mp_valid = np.ascontiguousarray(mp_valid, np.uint8)
    mp_obs = np.ascontiguousarray(mp_obs, np.uint8)
    Rcw = np.ascontiguousarray(Rcw, np.float64)
    tcw = np.ascontiguousarray(tcw, np.float64)
    kp_xy = np.ascontiguousarray(kp_xy, np.float32)
    kp_level = np.ascontiguousarray(kp_level, np.int32)
    kp_desc = np.ascontiguousarray(kp_desc, np.uint8)
    kp_ur = np.ascontiguousarray(kp_ur, np.float32)
    occupied = np.ascontiguousarray(occupied, np.uint8)
    sf = np.ascontiguousarray(scale_factors, np.float32)
    m = len(pw)
    out = np.empty(m, np.int32)
    n = lib.project_match_last(
        pw.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        mp_desc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        mp_oct.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mp_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        mp_obs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), m,
        Rcw.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        tcw.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        float(fx), float(fy), float(cx), float(cy), float(mbf),
        float(min_x), float(max_x), float(min_y), float(max_y),
        kp_xy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        kp_level.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        kp_desc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        kp_ur.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        occupied.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(kp_xy),
        sf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(sf),
        float(th), int(match_th), int(same_octave_first),
        int(forward), int(backward),
        float(grid_min_x), float(grid_min_y), float(grid_w), float(grid_h),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out, n


def ba_schur(poses, points, cam_idx, pt_idx, obs_uv, obs_ur, inv_sigma2,
             fixed_cams, active, fx, fy, cx, cy, mbf, n_iters, use_huber,
             abort_buf=None):
    """Native Schur-complement BA (see orbslam3_native.cpp ba_schur).

    poses: (C, 12) row-major [R(9), t(3)]; points: (P, 3).  Returns
    (poses, points, chi2 (O,)) — new arrays — or None when the native lib
    is unavailable.  abort_buf: optional (1,) uint8 array another thread
    sets nonzero to interrupt the LM loop between iterations (the
    reference's mbAbortBA / g2o force-stop mechanism)."""
    lib = _load()
    if lib is None:
        return None
    poses = np.ascontiguousarray(poses, np.float64).copy()
    points = np.ascontiguousarray(points, np.float64).copy()
    cam_idx = np.ascontiguousarray(cam_idx, np.int32)
    pt_idx = np.ascontiguousarray(pt_idx, np.int32)
    obs_uv = np.ascontiguousarray(obs_uv, np.float64)
    obs_ur = np.ascontiguousarray(obs_ur, np.float64)
    is2 = np.ascontiguousarray(inv_sigma2, np.float64)
    fixed = np.ascontiguousarray(fixed_cams, np.uint8)
    act = np.ascontiguousarray(active, np.uint8)
    o = len(cam_idx)
    chi2 = np.empty(o, np.float64)
    rc = lib.ba_schur(
        poses.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cam_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pt_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        obs_uv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        obs_ur.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        is2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        fixed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        act.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(poses), len(points), o,
        float(fx), float(fy), float(cx), float(cy), float(mbf),
        int(n_iters), int(use_huber),
        chi2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        (
            abort_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            if abort_buf is not None
            else None
        ),
    )
    if rc != 0:
        return None
    return poses, points, chi2
