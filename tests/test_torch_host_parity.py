"""The port's own host back-end against the reference's, on the same inputs.

The port carries copies of the reference's JAX-free host modules (lie
groups, triangulation, PnP, two-view, bundle adjustment, the native C++
library, Tracking and the rest).  Fed the same numpy-seeded inputs in one
process, each copy runs the same numpy and C++ code (the native libraries
are built from the same source with the same flags), so the results are
asserted bit-identical: no tolerance is needed.  The torch dense matcher
(`search_by_projection_batch`, the reference's is JAX) must equal the
reference's integers, ties included.  One port `System` and one reference
`System` track the same 10-frame stereo sequence; an atlas the reference
saves loads into the port.  Thirty-nine of the copies differ from the
reference in nothing but the package's name and the upstream C++ paths
their comments cite, and two (`frontend/rectify.py`, `optim/two_view.py`)
besides only in named seams, the definitions that replace cv2; a test
holds each to that.
"""

import ast
import difflib
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam3_tpu import native as ref_native
from orbslam3_tpu.cameras.models import Pinhole as RefPinhole
from orbslam3_tpu.frontend import stereo_frame as ref_sf
from orbslam3_tpu.ops import matching as ref_matching
from orbslam3_tpu.optim import local_ba as ref_local_ba
from orbslam3_tpu.optim import pnp as ref_pnp
from orbslam3_tpu.optim import triangulate as ref_tri
from orbslam3_tpu.optim import two_view as ref_two_view
from orbslam3_tpu.oracle.orb_cpu import PyramidParams as RefParams
from orbslam3_tpu.slam.system import System as RefSystem
from orbslam3_tpu.utils import lie as ref_lie
from orbslam3_tpu_torch import Pinhole, PyramidParams, native, stereo_sequence
from orbslam3_tpu_torch.ops import matching
from orbslam3_tpu_torch.optim import local_ba, pnp, triangulate, two_view
from orbslam3_tpu_torch.slam import system as port_system
from orbslam3_tpu_torch.slam.system import System
from orbslam3_tpu_torch.utils import lie

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the copies whose text is the reference's with `orbslam3_tpu` renamed and
# the upstream C++ paths in comments written ORB_SLAM3/...
VERBATIM_COPIES = [
    "cameras/__init__.py", "cameras/models.py", "frontend/__init__.py", "frontend/rectify.py",
    "imu/__init__.py", "imu/initialization.py", "imu/preintegration.py", "ops/__init__.py",
    "ops/brief_pattern.py", "optim/__init__.py", "optim/bundle_adjustment.py",
    "optim/essential_graph.py", "optim/global_ba.py", "optim/inertial.py", "optim/local_ba.py",
    "optim/local_inertial_ba.py", "optim/pnp.py", "optim/pose_optimization.py",
    "optim/sim3_optimizer.py", "optim/sim3_solver.py", "optim/triangulate.py",
    "optim/two_view.py", "oracle/__init__.py", "oracle/stereo_cpu.py", "slam/__init__.py",
    "slam/frame.py", "slam/keyframe.py", "slam/local_mapping.py", "slam/loop_closing.py",
    "slam/map.py", "slam/map_point.py", "slam/relocalization.py", "utils/__init__.py",
    "utils/lie.py", "utils/settings.py", "utils/synth.py", "utils/trajectory.py",
    "utils/viewer.py", "vocab/__init__.py", "vocab/keyframe_database.py",
    "vocab/vocabulary.py",
]
# copies with named seams: only the lines of these definitions (a method as
# "Class.method", the module docstring as "__doc__", the module's imports
# as "imports") and blank lines may differ from the renamed reference
SEAMS = {
    "frontend/rectify.py": (
        "__doc__", "imports", "_fma_f32", "remap_bilinear", "StereoRectifier.rectify",
    ),
    "optim/two_view.py": (
        "_opposite_of_minor", "_sign", "_rotation_from", "decompose_homography",
        "TwoViewReconstruction.reconstruct",
    ),
}
FX = 350.0
H, W = 384, 512
MBF = FX * 0.12
N_FEATURES = 900
INTRINSICS = [FX, FX, W / 2, H / 2]


def _arrays(x) -> list:
    """The numpy leaves of a result (SE3 / Sim3 as R, t and s)."""
    if x is None or isinstance(x, (bool, int, float, np.ndarray, np.generic)):
        return [np.asarray(x)]
    if isinstance(x, (tuple, list)):
        return [a for item in x for a in _arrays(item)]
    return [np.asarray(getattr(x, k)) for k in ("s", "R", "t") if hasattr(x, k)]


def _lie_se3(m):
    xi = np.random.default_rng(1).normal(0, 0.7, (5, 6))
    return [(T.R, T.t, T.log()) for T in (m.SE3.exp(x) for x in xi)]


def _lie_sim3(m):
    xi = np.random.default_rng(2).normal(0, 0.5, (5, 7))
    return [(S.s, S.R, S.t, S.log()) for S in (m.Sim3.exp(x) for x in xi)]


def _scene(seed, n=120):
    rng = np.random.default_rng(seed)
    pw = rng.uniform([-2, -1.5, 2], [2, 1.5, 8], (n, 3))
    xi = rng.normal(0, 0.1, 6)
    return rng, pw, xi


def _triangulate(tri_mod, lie_mod):
    rng, pw, xi = _scene(3)
    t1, t2 = lie_mod.SE3(), lie_mod.SE3.exp(xi)
    b1 = pw / np.linalg.norm(pw, axis=1, keepdims=True)
    pc2 = pw @ t2.R.T + t2.t
    b2 = pc2 / np.linalg.norm(pc2, axis=1, keepdims=True) + rng.normal(0, 1e-4, pc2.shape)
    return tri_mod.triangulate_linear(b1, b2, t1, t2)


def _pnp(pnp_mod, lie_mod, cam):
    rng, pw, xi = _scene(4)
    t = lie_mod.SE3.exp(xi)
    uv = cam.project(pw @ t.R.T + t.t) + rng.normal(0, 0.5, (len(pw), 2))
    uv[:20] += rng.uniform(-80, 80, (20, 2))  # outliers
    return pnp_mod.pnp_ransac(pw, uv, cam, iterations=100, seed=1)


def _two_view(tv_mod, lie_mod, cam):
    rng, pw, _ = _scene(5, 200)
    t21 = lie_mod.SE3(lie_mod.so3_exp([0.02, -0.15, 0.01]), np.array([0.4, 0.02, 0.05]))
    p1 = cam.project(pw) + rng.normal(0, 0.4, (len(pw), 2))
    p2 = cam.project(pw @ t21.R.T + t21.t) + rng.normal(0, 0.4, (len(pw), 2))
    return tv_mod.TwoViewReconstruction(cam, seed=1).reconstruct(p1, p2)


def _hamming(native_mod):
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (300, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (200, 32), dtype=np.uint8)
    return native_mod.hamming_matrix(a, b)


def _octree(native_mod):
    rng = np.random.default_rng(7)
    kps = np.column_stack([
        rng.uniform(0, W, 3000), rng.uniform(0, H, 3000), rng.integers(1, 80, 3000)
    ]).astype(np.float32)
    return native_mod.distribute_octree(kps, 0, W, 0, H, 500)


HOST_CASES = {
    "lie_se3": (lambda: _lie_se3(lie), lambda: _lie_se3(ref_lie)),
    "lie_sim3": (lambda: _lie_sim3(lie), lambda: _lie_sim3(ref_lie)),
    "triangulate_linear": (lambda: _triangulate(triangulate, lie),
                           lambda: _triangulate(ref_tri, ref_lie)),
    "pnp_ransac": (lambda: _pnp(pnp, lie, Pinhole(INTRINSICS)),
                   lambda: _pnp(ref_pnp, ref_lie, RefPinhole(INTRINSICS))),
    "two_view": (lambda: _two_view(two_view, lie, Pinhole(INTRINSICS)),
                 lambda: _two_view(ref_two_view, ref_lie, RefPinhole(INTRINSICS))),
    "native_hamming_matrix": (lambda: _hamming(native), lambda: _hamming(ref_native)),
    "native_distribute_octree": (lambda: _octree(native), lambda: _octree(ref_native)),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_function_matches_reference(case):
    """Same code, same inputs, one process: bit-identical results."""
    assert native.available() and ref_native.available()
    got, want = (_arrays(fn()) for fn in HOST_CASES[case])
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("path", VERBATIM_COPIES)
def test_copy_differs_from_reference_only_in_names(path):
    def read(package):
        with open(os.path.join(REPO, package, path)) as f:
            return f.read()

    want = re.sub(r"\borbslam3_tpu\b", "orbslam3_tpu_torch", read("orbslam3_tpu"))
    want = re.sub(r"/[a-z]+/reference/", "ORB_SLAM3/", want)
    got = read("orbslam3_tpu_torch")
    if path not in SEAMS:
        assert got == want
        return
    seams = [_seam_lines(text, SEAMS[path]) for text in (want, got)]
    want_lines, got_lines = want.splitlines(), got.splitlines()
    ops = difflib.SequenceMatcher(None, want_lines, got_lines, autojunk=False).get_opcodes()
    outside = [
        (side, i + 1, lines[i])
        for tag, i1, i2, j1, j2 in ops if tag != "equal"
        for side, lines, rng, inside in (
            ("reference", want_lines, range(i1, i2), seams[0]),
            ("port", got_lines, range(j1, j2), seams[1]),
        )
        for i in rng if lines[i].strip() and i + 1 not in inside
    ]
    assert not outside, outside
    assert all(seams), "a named seam is missing"


def _seam_lines(text: str, names) -> set:
    """1-based numbers of the lines of the named top-level definitions."""
    tree = ast.parse(text)
    lines = set()

    def add(node):
        first = min([node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])])
        lines.update(range(first, node.end_lineno + 1))

    for k, node in enumerate(tree.body):
        if k == 0 and "__doc__" in names and isinstance(node, ast.Expr):
            add(node)
        elif "imports" in names and isinstance(node, (ast.Import, ast.ImportFrom)):
            add(node)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name in names:
                add(node)
            for item in getattr(node, "body", []) if isinstance(node, ast.ClassDef) else []:
                if isinstance(item, ast.FunctionDef) and f"{node.name}.{item.name}" in names:
                    add(item)
    return lines


# --- the dense device matcher ------------------------------------------------
def _matcher_inputs(seed, m=700, k=300):
    rng = np.random.default_rng(seed)
    kp_desc = rng.integers(0, 256, (k, 32), dtype=np.uint8)
    # map-point descriptors copied from keypoints with a few bits flipped,
    # many of them from the same keypoint: equal distances (forced ties)
    src = rng.integers(0, k // 6, m)
    mp_desc = kp_desc[src].copy()
    flip = rng.integers(0, 32, (m, 2))
    mp_desc[np.arange(m), flip[:, 0]] ^= np.uint8(1) << rng.integers(0, 8, m).astype(np.uint8)
    kp_desc[k // 2 :] = kp_desc[: k - k // 2]  # duplicate keypoints: tied columns
    kp_xy = rng.uniform(0, 160, (k, 2)).astype(np.float32)
    kp_xy[k // 2 :] = kp_xy[: k - k // 2]
    proj = (kp_xy[src] + rng.normal(0, 3, (m, 2))).astype(np.float32)
    return [
        proj, rng.integers(0, 4, m).astype(np.int32),
        rng.uniform(2, 30, m).astype(np.float32), mp_desc, rng.random(m) < 0.9,
        kp_xy, rng.integers(0, 4, k).astype(np.int32), kp_desc, rng.random(k) < 0.9,
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_by_projection_batch_matches_reference(seed, monkeypatch):
    args = _matcher_inputs(seed)
    # several passes over the map points
    monkeypatch.setattr(matching, "MATCH_CHUNK", 256)
    got = matching.search_by_projection_batch(*map(torch.from_numpy, args), th_desc=50, ratio=0.8)
    want = ref_matching.search_by_projection_batch(*map(jnp.asarray, args), th_desc=50, ratio=0.8)
    assert int(np.asarray(want[2]).sum()) > 20
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    dist = torch.from_numpy(np.array(ref_matching.hamming_matrix(
        jnp.asarray(args[3]), jnp.asarray(args[7]))))
    valid = torch.from_numpy(np.random.default_rng(seed).random(tuple(dist.shape)) < 0.3)
    for fn in ("masked_argmin", "masked_two_best"):
        g = getattr(matching, fn)(dist, valid)
        w = getattr(ref_matching, fn)(jnp.asarray(dist.numpy()), jnp.asarray(valid.numpy()))
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --- one System against the other --------------------------------------------
@pytest.fixture(scope="module")
def frames():
    return stereo_sequence(10, Pinhole(INTRINSICS), 0.12, H, W, seed=1)


def _pinned_unpack(unpack, seen: list):
    """`unpack_host_features` recording each frame's features, with depth
    recomputed in numpy as mbf / (x - u_right) from the packed columns.

    The reference's XLA program contracts the disparity's multiply and
    subtract into fused multiply-adds inside its depth division, so its
    depth differs from the port's (which rounds like u_right) by up to a
    few tens of f32 ulps (~1.5e-5 m); every other column is bit-identical.
    Both packages take depth from the same formula here, as trig is
    pinned in tests/test_torch_extractor.py."""

    def wrapped(arr):
        feats = unpack(arr)
        seen.append({k: np.array(v) for k, v in feats.items()})
        ok = feats["u_right"] >= 0
        disparity = feats["kps"][:, 0].astype(np.float32) - feats["u_right"].astype(np.float32)
        feats["depth"] = np.where(
            ok, np.float32(MBF) / np.where(ok, disparity, np.float32(1)), np.float32(-1)
        ).astype(feats["depth"].dtype)
        return feats

    return wrapped


def _run(system, frames):
    poses = [system.track_stereo(l, r, timestamp=k / 20.0) for k, (l, r, _) in enumerate(frames)]
    return poses, system.map_stats()


@pytest.fixture(scope="module")
def twin_runs(frames, tmp_path_factory):
    seen = {"port": [], "ref": []}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(port_system, "unpack_host_features",
                   _pinned_unpack(port_system.unpack_host_features, seen["port"]))
        mp.setattr(ref_sf, "unpack_host_features",
                   _pinned_unpack(ref_sf.unpack_host_features, seen["ref"]))
        port = System(Pinhole(INTRINSICS), MBF, PyramidParams(n_features=N_FEATURES),
                      sequential=True, max_frames=8, device="cpu")
        ref = RefSystem(RefPinhole(INTRINSICS), MBF, RefParams(n_features=N_FEATURES),
                        sequential=True, max_frames=8)
        runs = {"port": _run(port, frames), "ref": _run(ref, frames)}
    finally:
        mp.undo()
    atlas = str(tmp_path_factory.mktemp("atlas") / "reference.atlas")
    ref.save_atlas(atlas)
    port.shutdown()
    ref.shutdown()
    return seen, runs, atlas, (port, ref)


def test_system_features_match_reference(twin_runs):
    seen, *_ = twin_runs
    assert len(seen["port"]) == len(seen["ref"]) == 10
    for got, want in zip(seen["port"], seen["ref"]):
        assert got.keys() == want.keys()
        for key in got:
            if key == "depth":  # the reference's contracted division (above)
                ulps = np.abs(got[key].view(np.int32) - want[key].view(np.int32))
                assert ulps.max() <= 64 and np.array_equal(got[key] > 0, want[key] > 0)
            else:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_system_poses_match_reference(twin_runs):
    _, runs, _, _ = twin_runs
    (port_poses, port_stats), (ref_poses, ref_stats) = runs["port"], runs["ref"]
    assert [p is None for p in port_poses] == [p is None for p in ref_poses]
    assert sum(p is not None for p in port_poses) == 10
    assert port_stats == ref_stats
    for p, r in zip(port_poses, ref_poses):
        np.testing.assert_allclose(p.t, r.t, rtol=0, atol=1e-6)
        np.testing.assert_allclose(p.R, r.R, rtol=0, atol=1e-6)


def test_local_bundle_adjustment_matches_reference(twin_runs):
    """One more local BA solve on each System's final map, from the same
    state: bit-identical keyframe poses and points."""
    *_, (port, ref) = twin_runs
    results = []
    for system, lba in ((port, local_ba), (ref, ref_local_ba)):
        m = system.atlas.get_current_map()
        kfs = sorted(m.get_all_keyframes(), key=lambda kf: kf.id)
        assert lba.local_bundle_adjustment(kfs[-1], m) > 0
        mps = sorted(m.get_all_map_points(), key=lambda mp: mp.id)
        results.append((np.stack([kf.Tcw.R for kf in kfs]), np.stack([kf.Tcw.t for kf in kfs]),
                        np.stack([mp.position for mp in mps])))
    for g, w in zip(*results):
        np.testing.assert_array_equal(g, w)


def test_reference_atlas_loads_into_the_port(twin_runs):
    _, runs, atlas, _ = twin_runs
    port = System(Pinhole(INTRINSICS), MBF, PyramidParams(n_features=N_FEATURES), device="cpu")
    port.load_atlas(atlas)
    assert port.map_stats() == runs["ref"][1]
    m = port.atlas.get_current_map()
    assert type(m).__module__ == "orbslam3_tpu_torch.slam.map"
    assert all(type(kf).__module__ == "orbslam3_tpu_torch.slam.keyframe"
               for kf in m.get_all_keyframes())
