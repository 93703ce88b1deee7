"""CPython-extension loops for the SLAM host path, with Python fallbacks.

Builds `src/hostops.cpp` into a real extension module on first import
(into the package's _build/, named by a hash of the source).  Each entry
point has a pure-Python fallback with identical semantics, so the package
works without a toolchain; `available()` reports which path is active.

These cover the per-object traversals the LandmarkTable can't vectorize
(slot lookups, visibility bookkeeping, VO cleanup, covisibility votes —
Tracking4.cc:273+ roles); the numeric work stays in NumPy/the table.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import sysconfig

import numpy as np

from orbslam3_tpu_torch._build import host_library

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "src", "hostops.cpp")
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", f"-I{sysconfig.get_paths()['include']}")
_mod = None
_tried = False


def _load():
    global _mod, _tried
    if _mod is not None or _tried:
        return _mod
    _tried = True
    so = host_library(
        _SRC, "_hostops", sysconfig.get_config_var("EXT_SUFFIX") or ".so", _FLAGS
    )
    if so is None:
        return None
    try:
        loader = importlib.machinery.ExtensionFileLoader("_hostops", so)
        spec = importlib.util.spec_from_file_location("_hostops", so, loader=loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        _mod = mod
    except Exception:
        _mod = None
    return _mod


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
def _as_list(mps) -> list:
    if isinstance(mps, list):
        return mps
    if isinstance(mps, np.ndarray):
        return mps.tolist()  # object dtype: C-speed unboxing
    return list(mps)


def slots_of(mps, table) -> np.ndarray:
    """Current slot per point; -1 where the point is not attached to `table`."""
    m = _load()
    n = len(mps)
    if m is not None:
        out = np.empty(n, np.int64)
        m.slots_fill(_as_list(mps), table, out)
        return out
    return np.fromiter(
        (mp._slot if getattr(mp, "_table", None) is table else -1 for mp in mps),
        np.int64,
        count=n,
    )


def mark_seen(map_points: np.ndarray, table, fid: int, stamp: np.ndarray) -> None:
    """Per non-None point: drop if bad, else bump n_visible, set
    last_frame_seen=fid, and stamp its table slot as matched-this-frame."""
    m = _load()
    if m is not None:
        m.mark_seen(map_points, table, fid, stamp)
        return
    for i in range(len(map_points)):
        mp = map_points[i]
        if mp is None:
            continue
        if mp.bad:
            map_points[i] = None
        else:
            mp.n_visible += 1
            mp.last_frame_seen = fid
            if getattr(mp, "_table", None) is table:
                stamp[mp._slot] = fid


def clean_vo(map_points: np.ndarray, outlier: np.ndarray) -> None:
    """Null every n_obs<1 association (clean-VO-matches role)."""
    m = _load()
    if m is not None:
        m.clean_vo(map_points, outlier)
        return
    for i in range(len(map_points)):
        mp = map_points[i]
        if mp is not None and mp.n_obs < 1:
            outlier[i] = False
            map_points[i] = None


def count_found(map_points: np.ndarray, outlier: np.ndarray) -> int:
    """Bump n_found on every inlier association; count map-anchored ones."""
    m = _load()
    if m is not None:
        return m.count_found(map_points, outlier)
    count = 0
    for i in range(len(map_points)):
        mp = map_points[i]
        if mp is not None and not outlier[i]:
            mp.n_found += 1
            if mp.n_obs > 0:
                count += 1
    return count


def n_obs_of(mps) -> np.ndarray:
    """mp.n_obs per entry; -1 for None (no bad check)."""
    m = _load()
    n = len(mps)
    out = np.empty(n, np.int64)
    if m is not None:
        m.n_obs_of(_as_list(mps), out)
        return out
    for i, mp in enumerate(mps):
        out[i] = -1 if mp is None else mp.n_obs
    return out


def obs_counts(mps) -> np.ndarray:
    """len(mp.observations) per entry; -1 for None/bad points."""
    m = _load()
    n = len(mps)
    counts = np.empty(n, np.int64)
    if m is not None:
        m.obs_counts(_as_list(mps), counts)
        return counts
    for i, mp in enumerate(mps):
        if mp is None or mp.bad:
            counts[i] = -1
        else:
            counts[i] = len(getattr(mp, "observations", None) or ())
    return counts


def collect_obs(mps: list):
    """Flatten the observation graphs of already-kept (non-None, non-bad,
    observed) points into parallel arrays, C-speed when available.

    Returns (pos (G,3) f64, need_norm (G,) bool, grp/kfi/left/right (T,) i64,
    kfs list of distinct KeyFrames interned by identity, in first-seen
    order).  Row order matches the Python iteration order exactly (point
    order, then observation insertion order), which downstream tie-breaking
    depends on."""
    g = len(mps)
    m = _load()
    if m is not None:
        counts = np.empty(g, np.int64)
        total = m.obs_counts(mps, counts)
        pos = np.empty((g, 3))
        needn = np.zeros(g, np.uint8)
        grp = np.empty(total, np.int64)
        kfi = np.empty(total, np.int64)
        left = np.empty(total, np.int64)
        right = np.empty(total, np.int64)
        kfs, t = m.fill_obs(mps, pos, needn, grp, kfi, left, right)
        return (pos, needn.astype(bool), grp[:t], kfi[:t], left[:t],
                right[:t], kfs)
    pos = np.empty((g, 3))
    needn = np.zeros(g, bool)
    grp, kfi, left, right = [], [], [], []
    kfs: list = []
    ids: dict = {}
    for i, mp in enumerate(mps):
        p = getattr(mp, "_position", None)
        pos[i] = mp.position if p is None else p
        needn[i] = getattr(mp, "ref_kf", None) is not None
        for kf, (l, r) in mp.observations.items():
            ki = ids.get(id(kf))
            if ki is None:
                ki = len(kfs)
                ids[id(kf)] = ki
                kfs.append(kf)
            grp.append(i)
            kfi.append(ki)
            left.append(l)
            right.append(r)
    return (pos, needn, np.asarray(grp, np.int64), np.asarray(kfi, np.int64),
            np.asarray(left, np.int64), np.asarray(right, np.int64), kfs)


def count_obs_kfs(map_points: np.ndarray) -> dict:
    """Covisibility votes: {kf: #current-frame points it observes}."""
    m = _load()
    if m is not None:
        return m.count_obs_kfs(map_points)
    counter: dict = {}
    for mp in map_points:
        if mp is None or mp.bad:
            continue
        for kf in mp.observations:
            if not kf.bad:
                counter[kf] = counter.get(kf, 0) + 1
    return counter
