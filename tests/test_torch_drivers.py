"""What users launch, in the port: the dataset drivers, and the bench and
the entry hook without a card.  The examples, the entry hook's step and
the ATE tool are in tests/test_torch_examples.py.

Fast tier, on the CPU, a few frames: each port driver (EuRoC stereo,
stereo-inertial, `--pipeline 2`, `--batch 4`, KITTI, TUM-RGBD with and
without `--fused`, TUM-VI)
reads its dataset tree with `utils.imageio` and must give poses bit for
bit equal to the port's `System` built from the same settings file and
driven by hand on the same images read by cv2 (once for each tree,
settings file and sensor); the trees and the EuRoC YAML come from
tests/test_dataset_drivers.py's writers.  Without a card,
every driver on its default device, the bench and the entry hook refuse.

Slow tier, at that file's 14 frames: each port driver against the JAX
package's driver on the same tree.  The front-ends agree bit for bit
except the reference's stereo depth, which XLA's fused multiply-adds move
by a few ulps (tests/test_torch_host_parity.py); with depth pinned the
way that file pins it, the poses agree within 1e-6 m.  The inertial
drivers run with depth as it comes: the same tracked count and the ATE
bar of 2 cm, and the largest pose difference printed.
"""

import csv
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from orbslam3_tpu.cameras.models import KannalaBrandt8 as RefKB8, Pinhole as RefPinhole
from orbslam3_tpu.utils.lie import SE3 as RefSE3
from orbslam3_tpu.utils.synth import (
    imu_samples_between,
    render_world,
    rgbd_sequence,
    stereo_sequence,
)
from orbslam3_tpu_torch.examples import (
    common,
    run_euroc,
    run_kitti,
    run_tum_rgbd,
    run_tumvi,
)
from orbslam3_tpu_torch.ops.extractor import FusedKernels
from orbslam3_tpu_torch.slam.system import System
from orbslam3_tpu_torch.utils.synth import ate_rmse
from orbslam3_tpu_torch.utils.lie import SE3
from orbslam3_tpu_torch.utils.trajectory import quat_to_rot

from test_dataset_drivers import N_FRAMES, _TBC, _euroc_yaml, _write_euroc_tree
from test_rectified_slam import BASELINE, CAM_L, CAM_R, H, T_RL, W
from test_tumvi_inertial import BASELINE as KB_BASELINE, H as KH, TBC, W as KW, _pose, _world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0_NS = int(1403636579 * 1e9)
KB8_PARAMS = [160.0, 160.0, KW / 2, KH / 2, 0.0035, 0.0008, -0.0034, 0.0006]
FAST_FRAMES = 4


# --- trees and settings files -------------------------------------------------
def _matrix(t) -> str:
    m = np.eye(4)
    m[:3, :3] = t.R
    m[:3, 3] = t.t
    return ",".join(f"{v:.12f}" for v in m.reshape(-1))


def _write_imu(seq: str, n: int, tbc, pose_fn=None) -> None:
    os.makedirs(os.path.join(seq, "imu0"))
    with open(os.path.join(seq, "imu0", "data.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["#timestamp [ns]", "w_x", "w_y", "w_z", "a_x", "a_y", "a_z"])
        for k in range(n - 1):
            acc, gyro, dts = imu_samples_between(k, k + 1, Tbc=tbc, pose_fn=pose_fn)
            t = T0_NS + int(k / 20.0 * 1e9)
            for a, g, dt in zip(acc, gyro, dts):
                t += int(dt * 1e9)
                w.writerow([t, *g, *a])


def _imu_yaml(tbc, noise=(1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3)) -> str:
    return f"""IMU.NoiseGyro: {noise[0]}
IMU.NoiseAcc: {noise[1]}
IMU.GyroWalk: {noise[2]}
IMU.AccWalk: {noise[3]}
IMU.Frequency: 200
IMU.T_b_c1: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [{_matrix(tbc)}]
"""


def _orb_yaml(n_features: int) -> str:
    return f"""ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def make_euroc(root: str, n: int) -> dict:
    """EuRoC ASL tree of tests/test_dataset_drivers.py's distorted rig,
    with imu0, and its stereo and stereo-inertial YAMLs."""
    frames = stereo_sequence(n, CAM_L, BASELINE, H, W, seed=3, camera_r=CAM_R, T_rl=T_RL)
    seq = os.path.join(root, "mav0")
    _write_euroc_tree(seq, frames)
    _write_imu(seq, n, _TBC)
    stereo = os.path.join(root, "EuRoC.yaml")
    _euroc_yaml(stereo)
    inertial = os.path.join(root, "EuRoC_VI.yaml")
    _euroc_yaml(inertial)
    with open(inertial, "a") as f:
        f.write(_imu_yaml(_TBC))
    return dict(seq=seq, frames=frames, stereo=stereo, inertial=inertial)


def make_kitti(root: str, n: int) -> dict:
    cam = RefPinhole([350.0, 350.0, W / 2, H / 2])
    frames = stereo_sequence(n, cam, BASELINE, H, W, seed=5)
    seq = os.path.join(root, "seq")
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, sub))
    for k, (il, ir, _) in enumerate(frames):
        cv2.imwrite(os.path.join(seq, "image_0", f"{k:06d}.png"), il)
        cv2.imwrite(os.path.join(seq, "image_1", f"{k:06d}.png"), ir)
    with open(os.path.join(seq, "times.txt"), "w") as f:
        f.write("".join(f"{k / 10.0:.6f}\n" for k in range(n)))
    settings = os.path.join(root, "KITTI.yaml")
    with open(settings, "w") as f:
        f.write(f"""%YAML:1.0
---
File.version: "1.0"
Camera.type: "Rectified"
Camera1.fx: {cam.fx}
Camera1.fy: {cam.fy}
Camera1.cx: {cam.cx}
Camera1.cy: {cam.cy}
Camera.width: {W}
Camera.height: {H}
Camera.fps: 10
Camera.bf: {BASELINE * cam.fx}
Stereo.ThDepth: 40.0
""" + _orb_yaml(900))
    return dict(seq=seq, frames=frames, settings=settings)


def make_tum_rgbd(root: str, n: int) -> dict:
    """TUM-RGBD tree: colour frames (channels that differ, so reading them
    as grey runs libpng's conversion) and 16-bit depth at 5000 units/m."""
    cam = RefPinhole([350.0, 350.0, W / 2, H / 2])
    frames = rgbd_sequence(n, cam, H, W, seed=7, depth_factor=5000.0)
    seq = os.path.join(root, "seq")
    os.makedirs(os.path.join(seq, "rgb"))
    os.makedirs(os.path.join(seq, "depth"))
    assoc, stamps = [], []
    for k, (img, depth, _) in enumerate(frames):
        ts = 1305031100.0 + k / 20.0
        bgr = np.stack([img, img, np.clip(img.astype(int) + 9, 0, 255)], -1).astype(np.uint8)
        cv2.imwrite(os.path.join(seq, "rgb", f"{ts:.6f}.png"), bgr)
        cv2.imwrite(os.path.join(seq, "depth", f"{ts:.6f}.png"),
                    np.clip(depth, 0, 65535).astype(np.uint16))
        assoc.append(f"{ts:.6f} rgb/{ts:.6f}.png {ts:.6f} depth/{ts:.6f}.png")
        stamps.append(ts)
    with open(os.path.join(seq, "associations.txt"), "w") as f:
        f.write("\n".join(assoc) + "\n")
    settings = os.path.join(root, "TUM.yaml")
    with open(settings, "w") as f:
        f.write(f"""%YAML:1.0
---
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: {cam.fx}
Camera1.fy: {cam.fy}
Camera1.cx: {cam.cx}
Camera1.cy: {cam.cy}
Camera.width: {W}
Camera.height: {H}
Camera.fps: 20
Camera.bf: {BASELINE * cam.fx}
Stereo.ThDepth: 40.0
RGBD.DepthMapFactor: 5000.0
""" + _orb_yaml(900))
    return dict(seq=seq, frames=frames, settings=settings, stamps=stamps)


def make_tumvi(root: str, n: int) -> dict:
    """TUM-VI tree: two KB8 cameras with lapping areas over the whole
    image, IMU, tests/test_dataset_drivers.py's TUM-VI settings."""
    cam = RefKB8(KB8_PARAMS)
    walls = _world()
    t_rl = RefSE3(np.eye(3), np.array([-KB_BASELINE, 0.0, 0.0]))
    frames = []
    for k in range(n):
        tcw = _pose(k).inverse()
        frames.append((render_world(walls, cam, tcw, KH, KW),
                       render_world(walls, cam, t_rl * tcw, KH, KW), tcw))
    seq = os.path.join(root, "mav0")
    _write_euroc_tree(seq, frames)
    _write_imu(seq, n, TBC, pose_fn=_pose)
    kb = "\n".join(f"Camera{c}.{name}: {v}" for c in (1, 2) for name, v in zip(
        ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"), KB8_PARAMS))
    settings = os.path.join(root, "TUMVI.yaml")
    with open(settings, "w") as f:
        f.write(f"""%YAML:1.0
---
File.version: "1.0"
Camera.type: "KannalaBrandt8"
{kb}
Camera1.overlappingBegin: 0
Camera1.overlappingEnd: {KW}
Camera2.overlappingBegin: 0
Camera2.overlappingEnd: {KW}
Camera.width: {KW}
Camera.height: {KH}
Camera.fps: 20
Camera.RGB: 1
Stereo.ThDepth: 40.0
Stereo.T_c1_c2: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [1.0,0.0,0.0,{KB_BASELINE},0.0,1.0,0.0,0.0,0.0,0.0,1.0,0.0,0.0,0.0,0.0,1.0]
Stereo.b: {KB_BASELINE}
""" + _imu_yaml(TBC, (1.0e-4, 1.0e-3, 1.0e-6, 1.0e-5)) + _orb_yaml(700))
    return dict(seq=seq, frames=frames, settings=settings)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    made = {}
    for name, make in (("euroc", make_euroc), ("kitti", make_kitti),
                       ("tum_rgbd", make_tum_rgbd), ("tumvi", make_tumvi)):
        os.makedirs(root / name)
        made[name] = make(str(root / name), FAST_FRAMES)
    return made


# --- the port's System driven by hand -----------------------------------------
def _asl_by_hand(tree, settings, sensor):
    """run_euroc's loop, written out: cv2 reads, track_stereo, the IMU
    samples in (previous frame, this frame]."""
    slam = System.from_files(None, settings, sensor=sensor, device="cpu")
    cam0, cam1 = (os.path.join(tree["seq"], c) for c in ("cam0", "cam1"))
    imu = run_euroc.load_imu(os.path.join(tree["seq"], "imu0")) if "inertial" in sensor else None
    prev = None
    for ns, name in run_euroc.load_timestamps(cam0):
        left = cv2.imread(os.path.join(cam0, "data", name), cv2.IMREAD_GRAYSCALE)
        right = cv2.imread(os.path.join(cam1, "data", name), cv2.IMREAD_GRAYSCALE)
        samples = None
        if imu is not None and prev is not None:
            ts, gyro, acc = imu
            sel = (ts > prev) & (ts <= ns)
            dts = np.diff(np.concatenate([[prev], ts[sel]])) * 1e-9
            samples = (acc[sel], gyro[sel], dts) if sel.any() else None
        slam.track_stereo(left, right, ns * 1e-9, imu=samples)
        prev = ns
    slam.shutdown()
    return slam


def _euroc_stereo_by_hand(tree):
    """The by-hand run of the three EuRoC stereo cases, which share it."""
    return _asl_by_hand(tree, tree["stereo"], "stereo")


def _kitti_by_hand(tree):
    slam = System.from_files(None, tree["settings"], sensor="stereo", device="cpu")
    names = sorted(os.listdir(os.path.join(tree["seq"], "image_0")))
    for k, name in enumerate(names):
        left, right = (cv2.imread(os.path.join(tree["seq"], d, name), cv2.IMREAD_GRAYSCALE)
                       for d in ("image_0", "image_1"))
        slam.track_stereo(left, right, k / 10.0)
    slam.shutdown()
    return slam


def _tum_rgbd_by_hand(tree, fused=FusedKernels()):
    slam = System.from_files(None, tree["settings"], sensor=System.RGBD, device="cpu",
                             fused=fused)
    for ts, rgb, depth in run_tum_rgbd.load_associations(
        os.path.join(tree["seq"], "associations.txt")
    ):
        slam.track_rgbd(cv2.imread(os.path.join(tree["seq"], rgb), cv2.IMREAD_GRAYSCALE),
                        cv2.imread(os.path.join(tree["seq"], depth), cv2.IMREAD_UNCHANGED), ts)
    slam.shutdown()
    return slam


# name -> (tree, port driver call, by-hand run)
CASES = {
    "euroc_stereo": ("euroc", lambda t, d, **kw: run_euroc.main(
        t["seq"], t["stereo"], None, "stereo", out_dir=d, **kw), _euroc_stereo_by_hand),
    "euroc_stereo_inertial": ("euroc", lambda t, d, **kw: run_euroc.main(
        t["seq"], t["inertial"], None, "stereo-inertial", out_dir=d, **kw),
        lambda t: _asl_by_hand(t, t["inertial"], "stereo-inertial")),
    "euroc_pipeline2": ("euroc", lambda t, d, **kw: run_euroc.main(
        t["seq"], t["stereo"], None, "stereo", pipeline=2, out_dir=d, **kw),
        _euroc_stereo_by_hand),
    "euroc_batch4": ("euroc", lambda t, d, **kw: run_euroc.main(
        t["seq"], t["stereo"], None, "stereo", batch=4, out_dir=d, **kw),
        _euroc_stereo_by_hand),
    "kitti": ("kitti", lambda t, d, **kw: run_kitti.main(
        t["seq"], t["settings"], out_dir=d, **kw), _kitti_by_hand),
    "tum_rgbd": ("tum_rgbd", lambda t, d, **kw: run_tum_rgbd.main(
        t["seq"], t["settings"], out_dir=d, **kw), _tum_rgbd_by_hand),
    "tum_rgbd_fused": ("tum_rgbd", lambda t, d, **kw: run_tum_rgbd.main(
        t["seq"], t["settings"], out_dir=d, fused=common.parse_fused("detect,moments,sample"),
        **kw), lambda t: _tum_rgbd_by_hand(t, FusedKernels(True, True, True))),
    "tumvi": ("tumvi", lambda t, d, **kw: run_tumvi.main(
        t["seq"], t["settings"], out_dir=d, **kw),
        lambda t: _asl_by_hand(t, t["settings"], "stereo-inertial")),
}


def _poses(slam) -> list:
    return [(ts, twc.R, twc.t) for ts, twc in slam.frame_trajectory()]


@pytest.fixture(scope="module")
def by_hand_poses(trees):
    """The poses of each by-hand run, keyed by (tree, by-hand run): the
    three EuRoC stereo cases drive one System by hand once."""
    memo = {}

    def poses(tree_name, by_hand):
        if (tree_name, by_hand) not in memo:
            memo[tree_name, by_hand] = _poses(by_hand(trees[tree_name]))
        return memo[tree_name, by_hand]

    return poses


@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_equals_system_driven_by_hand(trees, by_hand_poses, tmp_path, case):
    tree_name, drive, by_hand = CASES[case]
    slam = drive(trees[tree_name], str(tmp_path), device="cpu")
    got, want = _poses(slam), by_hand_poses(tree_name, by_hand)
    assert len(got) == len(want) == FAST_FRAMES
    for (tg, rg, pg), (tw, rw, pw) in zip(got, want):
        assert tg == tw
        np.testing.assert_array_equal(rg, rw)
        np.testing.assert_array_equal(pg, pw)
    assert os.path.getsize(tmp_path / "CameraTrajectory.txt") > 0


@pytest.mark.parametrize("case", ["euroc_stereo", "kitti", "tum_rgbd", "tumvi"])
def test_driver_refuses_without_a_card(trees, tmp_path, case):
    """The default device is the card; with none it raises, never runs on
    the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tree_name, drive, _ = CASES[case]
    with pytest.raises(RuntimeError, match="cuda"):
        drive(trees[tree_name], str(tmp_path))


@pytest.mark.parametrize("module", ["examples.run_euroc", "bench", "entry"])
def test_entry_points_exit_nonzero_without_a_card(trees, tmp_path, module):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = {"examples.run_euroc": [trees["euroc"]["seq"], trees["euroc"]["stereo"]]}
    proc = subprocess.run(
        [sys.executable, "-m", f"orbslam3_tpu_torch.{module}", *args.get(module, [])],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert proc.returncode != 0
    if module == "bench":
        last = proc.stdout.strip().splitlines()[-1]
        assert '"value": null' in last and '"vs_baseline": null' in last


def test_parse_fused():
    assert common.parse_fused("") == (False, False, False)
    assert common.parse_fused("detect,sample") == (True, False, True)
    assert common.parse_fused("detect,moments,sample") == (True, True, True)
    with pytest.raises(ValueError, match="nms"):
        common.parse_fused("detect,nms")


# --- slow: the port's drivers against the JAX package's ------------------------
def _pin_depth(monkeypatch, mbf: float) -> None:
    """Stereo depth from numpy as mbf / (x - u_right) in both packages,
    as tests/test_torch_host_parity.py pins it."""
    from orbslam3_tpu.frontend import stereo_frame as ref_sf
    from orbslam3_tpu_torch.slam import system as port_system

    def pinned(real):
        def unpack(arr):
            feats = real(arr)
            ok = feats["u_right"] >= 0
            disparity = feats["kps"][:, 0].astype(np.float32) - feats["u_right"].astype(np.float32)
            feats["depth"] = np.where(
                ok, np.float32(mbf) / np.where(ok, disparity, np.float32(1)), np.float32(-1)
            ).astype(feats["depth"].dtype)
            return feats

        return unpack

    for module in (port_system, ref_sf):
        monkeypatch.setattr(module, "unpack_host_features", pinned(module.unpack_host_features))


def _reference_driver(name):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import importlib

    return importlib.import_module(name)


def _trajectory(path: str, kitti: bool = False) -> list:
    rows = [[float(v) for v in line.split()] for line in open(path) if line.strip()]
    if kitti:
        return [SE3(np.array(r).reshape(3, 4)[:, :3], np.array(r).reshape(3, 4)[:, 3]) for r in rows]
    return [SE3(quat_to_rot(np.array(r[4:8])), np.array(r[1:4])) for r in rows]


SLOW_CASES = {
    # name: (tree, reference module, reference args, port call, pinned, KITTI format)
    "euroc_stereo": ("euroc", "run_euroc", lambda t: (t["seq"], t["stereo"], None, "stereo"),
                     CASES["euroc_stereo"][1], True, False),
    "euroc_pipeline2": ("euroc", "run_euroc", lambda t: (t["seq"], t["stereo"], None, "stereo"),
                        CASES["euroc_pipeline2"][1], True, False),
    "euroc_batch4": ("euroc", "run_euroc", lambda t: (t["seq"], t["stereo"], None, "stereo"),
                     CASES["euroc_batch4"][1], True, False),
    "euroc_stereo_inertial": ("euroc", "run_euroc",
                              lambda t: (t["seq"], t["inertial"], None, "stereo-inertial"),
                              CASES["euroc_stereo_inertial"][1], False, False),
    "kitti": ("kitti", "run_kitti", lambda t: (t["seq"], t["settings"]),
              CASES["kitti"][1], True, True),
    "tum_rgbd": ("tum_rgbd", "run_tum_rgbd", lambda t: (t["seq"], t["settings"]),
                 CASES["tum_rgbd"][1], False, False),
    "tumvi": ("tumvi", "run_tumvi", lambda t: (t["seq"], t["settings"]),
              CASES["tumvi"][1], False, False),
}


@pytest.fixture(scope="module")
def slow_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("slow_trees")
    made = {}
    for name, make in (("euroc", make_euroc), ("kitti", make_kitti),
                       ("tum_rgbd", make_tum_rgbd), ("tumvi", make_tumvi)):
        os.makedirs(root / name)
        made[name] = make(str(root / name), N_FRAMES)
    return made


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(SLOW_CASES))
def test_driver_matches_jax_driver(slow_trees, tmp_path, monkeypatch, case):
    tree_name, ref_name, ref_args, drive, pinned, kitti = SLOW_CASES[case]
    tree = slow_trees[tree_name]
    settings = ref_args(tree)[1]
    port_system = System.from_files(None, settings, sensor="stereo", device="cpu")
    if pinned:
        _pin_depth(monkeypatch, port_system.mbf)
    kw = {"pipeline": 2} if case == "euroc_pipeline2" else {"batch": 4} if case == "euroc_batch4" else {}
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    os.makedirs(ref_dir)
    os.makedirs(port_dir)
    monkeypatch.chdir(ref_dir)
    _reference_driver(ref_name).main(*ref_args(tree), **kw)
    monkeypatch.chdir(port_dir)
    drive(tree, str(port_dir), device="cpu")
    want = _trajectory(str(ref_dir / "CameraTrajectory.txt"), kitti)
    got = _trajectory(str(port_dir / "CameraTrajectory.txt"), kitti)
    assert len(got) == len(want) == N_FRAMES
    diff = max(max(np.abs(g.t - w.t).max(), np.abs(g.R - w.R).max()) for g, w in zip(got, want))
    print(f"{case}: largest pose difference port vs JAX driver {diff:.3g}")
    if pinned:
        assert diff <= 1e-6  # the files' 7 decimals, so 1e-6 m is their resolution
    else:
        gt = [SE3(f[2].R, f[2].t) for f in tree["frames"]]
        if port_system.rectifier is not None:  # poses in the rectified left frame
            gt = [SE3(port_system.rectifier.R1, np.zeros(3)) * g for g in gt]
        for traj in (got, want):
            assert ate_rmse([t.inverse() for t in traj], gt) < 0.02
