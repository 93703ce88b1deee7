"""The port stands alone: it imports neither JAX nor the JAX package.

Two checks.  An AST scan of every module of the port and of chip_smoke.py
finds no `import` / `from` of `jax*` or `orbslam3_tpu(.*)` at any depth
(function bodies included) and no such string handed to an import
function.  A subprocess whose `sys.meta_path` refuses `jax` and
`orbslam3_tpu` drives the port's host paths on the CPU: stereo, mono and
RGB-D frames, the device local-map matcher (DEVICE_MATCH_MIN lowered),
`trace_range` and `device_trace`, the trajectory savers, an atlas saved
by the port and one saved by the reference, both loaded by the port, the
stereo fisheye path and batched prefetch, and every module users launch
(the examples, the entry hook, the bench, the ATE tool, the soak and the
tools that measure the whole System); the
frame graphs (`utils.frame_graph`) and the launch registry are among the
modules it loads.

No module of the port imports cv2 or PIL (the synthetic textures and the
viewer draw with `utils/raster.py`), and chip_smoke.py only in the
function that draws the texture with cv2 to compare; the EuRoC driver
runs on a distorted rig in a process that refuses jax, the JAX package,
cv2 and PIL.
"""

import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "orbslam3_tpu")
IMPORT_FUNCS = ("import_module", "__import__", "find_spec", "spec_from_file_location")


def _blocked(name: str) -> bool:
    return name.split(".")[0] in BLOCKED


def _port_sources() -> list:
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "orbslam3_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_no_module_of_the_port_imports_jax_or_the_reference():
    found = []
    sources = _port_sources()
    assert len(sources) > 60  # the port's own host back-end is there
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.Call):
                fn = node.func
                fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
                if fname in IMPORT_FUNCS:
                    names = [
                        a.value for a in node.args
                        if isinstance(a, ast.Constant) and isinstance(a.value, str)
                    ]
            found += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}" for n in names if _blocked(n)]
    assert not found, found


_SCRIPT = textwrap.dedent(
    """
    import glob, os, sys


    class _Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "orbslam3_tpu"):
                raise ImportError("the port must not import " + name)
            return None


    sys.meta_path.insert(0, _Refuse())
    out, ref_atlas = sys.argv[1], sys.argv[2]

    from orbslam3_tpu_torch import (
        FusedKernels, Pinhole, PyramidParams, rgbd_sequence, stereo_sequence,
    )
    from orbslam3_tpu_torch.slam import matchers
    from orbslam3_tpu_torch.slam.system import System
    from orbslam3_tpu_torch.utils.benchmark import Benchmark, device_trace, trace_range

    devices = []
    real = matchers.search_by_projection_cands_device


    def counted(*a, **kw):
        devices.append(str(kw["device"]))
        return real(*a, **kw)


    matchers.search_by_projection_cands_device = counted
    matchers.DEVICE_MATCH_MIN = 1  # every local-map search takes the device matcher
    cam = Pinhole([350.0, 350.0, 256.0, 192.0])
    sysm = System(cam, 42.0, PyramidParams(n_features=900), device="cpu")
    frames = stereo_sequence(3, cam, 0.12, 384, 512, seed=1)
    with device_trace(os.path.join(out, "trace")):
        with trace_range("isolation.stereo", sysm.device):
            poses = [sysm.track_stereo(l, r, timestamp=k / 20.0) for k, (l, r, _) in enumerate(frames)]
    assert all(p is not None for p in poses), poses
    assert devices and set(devices) == {"cpu"}, devices
    assert glob.glob(os.path.join(out, "trace", "*.json")), os.listdir(out)
    assert len(Benchmark.the().records["isolation.stereo"]) == 1

    for saver in ("save_trajectory_tum", "save_trajectory_kitti", "save_trajectory_euroc",
                  "save_keyframe_trajectory_tum", "save_keyframe_trajectory_euroc"):
        path = os.path.join(out, saver + ".txt")
        getattr(sysm, saver)(path)
        assert os.path.getsize(path) > 0, saver
    atlas = os.path.join(out, "port.atlas")
    sysm.save_atlas(atlas)
    stats = sysm.map_stats()
    sysm.shutdown()
    for path, want in ((atlas, stats), (ref_atlas, None)):
        other = System(cam, 42.0, PyramidParams(n_features=900), device="cpu")
        other.load_atlas(path)
        got = other.map_stats()
        assert got["n_keyframes"] > 0 and (want is None or got == want), (path, got, want)
        kf = other.atlas.get_current_map().get_all_keyframes()[0]
        assert type(kf).__module__ == "orbslam3_tpu_torch.slam.keyframe"

    small = Pinhole([350.0, 350.0, 160.0, 120.0])
    params = PyramidParams(n_features=500)
    fused = FusedKernels(True, True, True)
    mono = System(small, 0.0, params, sensor=System.MONOCULAR, device="cpu", fused=fused)
    for k, (l, _, _) in enumerate(stereo_sequence(2, small, 0.12, 240, 320, seed=1)):
        mono.track_monocular(l, timestamp=k / 20.0)
    mono.shutdown()
    rgbd = System(small, 28.0, params, sensor=System.RGBD, device="cpu")
    for k, (img, depth, _) in enumerate(rgbd_sequence(2, small, 240, 320, seed=2)):
        rgbd.track_rgbd(img, depth, timestamp=k / 20.0)
    rgbd.shutdown()

    # the stereo fisheye path and batched prefetch
    import numpy as np
    import orbslam3_tpu_torch.oracle.stereo_cpu
    from orbslam3_tpu_torch.cameras.models import KannalaBrandt8
    from orbslam3_tpu_torch.tools import tumvi_scene
    from orbslam3_tpu_torch.utils.lie import SE3

    kb8 = KannalaBrandt8([133.3, 133.3, 160.0, 120.0, 0.0035, 0.0008, -0.0034, 0.0006])
    rig = System(kb8, 13.3, params, camera2=kb8, Tlr=SE3(np.eye(3), np.array([0.1, 0.0, 0.0])),
                 lapping1=(100.0, 220.0), lapping2=(100.0, 220.0), device="cpu")
    tlr = SE3(np.eye(3), np.array([0.1, 0.0, 0.0]))
    for k, (l, r, _, _) in enumerate(tumvi_scene.sequence(kb8, kb8, tlr, SE3(), 240, 320, 2)):
        assert rig.track_stereo(l, r, timestamp=k / 20.0) is not None
    assert rig.tracker.current.n_left < rig.tracker.current.n
    rig.shutdown()
    batch = System(small, 42.0, params, device="cpu")
    frames = stereo_sequence(2, small, 0.12, 240, 320, seed=1)
    handles = batch.prefetch_stereo_batch([(l, r) for l, r, _ in frames])
    for k, handle in enumerate(handles):
        batch.track_stereo_prefetched(handle, timestamp=k / 20.0)
    batch.shutdown()

    # what users launch imports without them too
    import orbslam3_tpu_torch.bench, orbslam3_tpu_torch.entry
    import orbslam3_tpu_torch.examples.demo_extract, orbslam3_tpu_torch.examples.run_euroc
    import orbslam3_tpu_torch.examples.run_kitti, orbslam3_tpu_torch.examples.run_multi_robot
    import orbslam3_tpu_torch.examples.run_synth, orbslam3_tpu_torch.examples.run_tum_rgbd
    import orbslam3_tpu_torch.examples.run_tumvi, orbslam3_tpu_torch.tools.evaluate_ate
    import orbslam3_tpu_torch.tools.soak
    # and the tools that measure the whole System
    import orbslam3_tpu_torch.tools.bench_matchers, orbslam3_tpu_torch.tools.bench_stages
    import orbslam3_tpu_torch.tools.bench_system, orbslam3_tpu_torch.tools.card
    import orbslam3_tpu_torch.tools.profile_host, orbslam3_tpu_torch.tools.trace_ops

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "orbslam3_tpu"))
    assert not leaked, leaked
    # the frame graphs and the launch registry were loaded under the refusal
    assert {"orbslam3_tpu_torch.utils.frame_graph", "orbslam3_tpu_torch.utils.launches"} <= set(
        sys.modules)
    print("ISOLATED_OK")
    """
)


def _reference_atlas(path: str) -> None:
    """An atlas saved by the reference System, tracked from the port's
    stereo features (so no JAX program is compiled here)."""
    from orbslam3_tpu.cameras.models import Pinhole as RefPinhole
    from orbslam3_tpu.oracle.orb_cpu import PyramidParams as RefParams
    from orbslam3_tpu.slam.system import System as RefSystem
    from orbslam3_tpu_torch import Pinhole, PyramidParams, stereo_sequence
    from orbslam3_tpu_torch.slam.system import System

    cam = Pinhole([350.0, 350.0, 256.0, 192.0])
    port = System(cam, 42.0, PyramidParams(n_features=900), device="cpu")
    ref = RefSystem(RefPinhole([350.0, 350.0, 256.0, 192.0]), 42.0, RefParams(n_features=900))
    for k, (l, r, _) in enumerate(stereo_sequence(2, cam, 0.12, 384, 512, seed=1)):
        ref.track_stereo_features(port._extract_stereo(l, r), k / 20.0, (0, 0, 512, 384))
    assert ref.map_stats()["n_keyframes"] > 0
    ref.save_atlas(path)
    ref.shutdown()
    port.shutdown()


def test_port_runs_with_jax_and_the_reference_refused(tmp_path):
    ref_atlas = str(tmp_path / "reference.atlas")
    _reference_atlas(ref_atlas)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp_path), ref_atlas],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED_OK" in proc.stdout


# what users launch, and the modules that replaced cv2 calls
DRIVER_SURFACE = (
    "orbslam3_tpu_torch/bench.py", "orbslam3_tpu_torch/entry.py",
    "orbslam3_tpu_torch/examples/demo_extract.py", "orbslam3_tpu_torch/examples/run_euroc.py",
    "orbslam3_tpu_torch/examples/run_kitti.py", "orbslam3_tpu_torch/examples/run_multi_robot.py",
    "orbslam3_tpu_torch/examples/run_synth.py", "orbslam3_tpu_torch/examples/run_tum_rgbd.py",
    "orbslam3_tpu_torch/examples/run_tumvi.py", "orbslam3_tpu_torch/tools/evaluate_ate.py",
    "orbslam3_tpu_torch/tools/soak.py", "orbslam3_tpu_torch/tools/bench_system.py",
    "orbslam3_tpu_torch/tools/bench_stages.py", "orbslam3_tpu_torch/tools/trace_ops.py",
    "orbslam3_tpu_torch/tools/bench_matchers.py", "orbslam3_tpu_torch/tools/profile_host.py",
    "orbslam3_tpu_torch/utils/imageio.py", "orbslam3_tpu_torch/utils/raster.py",
    "orbslam3_tpu_torch/utils/synth.py", "orbslam3_tpu_torch/utils/viewer.py",
    "orbslam3_tpu_torch/frontend/rectify.py", "orbslam3_tpu_torch/optim/two_view.py",
    "orbslam3_tpu_torch/slam/system.py",
)


def _imports(path: str) -> list:
    """(line, module) of every import in a source, function bodies included."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.append((node.lineno, node.module))
    return out


# the one place outside the port that may import cv2: the smoke's phase 22
# draws the texture with cv2.fillPoly and text with cv2.putText, where the
# card's machine has cv2, to hold the port's drawing (run in a process that
# refuses cv2 and PIL) to it
SMOKE_CV2_COMPARISON = ("chip_smoke.py", "_cv2_drawings")


def _lines_of(path: str, name: str) -> range:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    node = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    return range(node.lineno, node.end_lineno + 1)


def test_no_module_of_the_port_imports_cv2_or_pil():
    sources = {os.path.relpath(p, REPO): p for p in _port_sources()}
    assert set(DRIVER_SURFACE) <= set(sources)
    smoke, compare = SMOKE_CV2_COMPARISON
    allowed = _lines_of(sources[smoke], compare)
    found = [
        f"{rel}:{line} {name}"
        for rel, path in sorted(sources.items())
        for line, name in _imports(path) if name.split(".")[0] in ("cv2", "PIL")
        and not (rel == smoke and line in allowed)
    ]
    assert not found, found


_DRIVER_SCRIPT = textwrap.dedent(
    """
    import os, sys


    class _Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "orbslam3_tpu", "cv2", "PIL"):
                raise ImportError("the port must not import " + name)
            return None


    sys.meta_path.insert(0, _Refuse())
    seq, settings, out, n = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
    from orbslam3_tpu_torch.examples import run_euroc

    slam = run_euroc.main(seq, settings, None, "stereo", device="cpu", out_dir=out)
    assert slam.rectifier is not None  # the distorted rig, rectified without cv2
    with open(os.path.join(out, "CameraTrajectory.txt")) as f:
        assert len([line for line in f if line.strip()]) == n
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "orbslam3_tpu", "cv2", "PIL"))
    assert not leaked, leaked
    print("DRIVER_OK")
    """
)


def test_euroc_driver_runs_with_cv2_and_pil_refused(tmp_path):
    """The EuRoC driver on a distorted rig's ASL tree, in a process that
    refuses jax, the JAX package, cv2 and PIL: what the card's machine
    has installed is enough."""
    from orbslam3_tpu.utils.synth import stereo_sequence

    from test_dataset_drivers import _euroc_yaml, _write_euroc_tree
    from test_rectified_slam import BASELINE, CAM_L, CAM_R, H, T_RL, W

    n = 3
    frames = stereo_sequence(n, CAM_L, BASELINE, H, W, seed=3, camera_r=CAM_R, T_rl=T_RL)
    seq, settings = str(tmp_path / "mav0"), str(tmp_path / "EuRoC.yaml")
    _write_euroc_tree(seq, frames)
    _euroc_yaml(settings)
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER_SCRIPT, seq, settings, str(tmp_path), str(n)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "DRIVER_OK" in proc.stdout


def test_blocked_name_rule():
    assert _blocked("jax.numpy") and _blocked("orbslam3_tpu.slam.system") and _blocked("orbslam3_tpu")
    assert not _blocked("orbslam3_tpu_torch.slam") and not _blocked("numpy")
