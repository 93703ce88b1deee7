"""Port fisheye stereo front-end == the JAX package's, on a rendered
KannalaBrandt8 pair.

`extract_fisheye_pair` at 240x320 with 500 features, once with the lapping
area spanning the image and once with a partial one (so `mono_index` is
neither 0 nor N).  With trig pinned in both packages (atan2 of the exact
moments and cos/sin in numpy, `test_torch_extractor.pin_trig_jit`) every
column is equal; with platform trig the integer columns are equal, angles
agree to 1e-3 degrees and descriptors stay inside the bound of
tests/test_brief.py (at most 1 % differ, by at most 4 bits).
`compute_stereo_fisheye_matches` of both packages on the same features
gives equal depths, matches and points, and one `System.track_stereo`
frame of the fisheye configuration gives the same frame and map.  The
TUM-VI-configuration e2e of the port (`tools/tumvi_scene.py`, shrunk to
tests/test_tumvi_inertial.py's 288x384) is in the slow tier."""

import jax
import numpy as np
import pytest
import torch

from orbslam3_tpu.cameras.models import KannalaBrandt8 as RefKB8
from orbslam3_tpu.frontend import fisheye as jfe
from orbslam3_tpu.frontend import stereo_frame as jsf
from orbslam3_tpu.oracle.orb_cpu import PyramidParams
from orbslam3_tpu.slam.system import System as RefSystem
from orbslam3_tpu.utils.lie import SE3 as RefSE3
from orbslam3_tpu_torch import PyramidParams as TPyramidParams
from orbslam3_tpu_torch.cameras.models import KannalaBrandt8
from orbslam3_tpu_torch.frontend import fisheye as tfe
from orbslam3_tpu_torch.frontend import stereo_frame as tsf
from orbslam3_tpu_torch.slam.system import System
from orbslam3_tpu_torch.tools import tumvi_scene
from orbslam3_tpu_torch.utils.lie import SE3
from orbslam3_tpu_torch.utils.synth import render_world
from test_torch_extractor import pin_trig_jit

H, W = 240, 320
BASELINE = 0.1
KB8 = [133.3, 133.3, W / 2, H / 2, 0.0035, 0.0008, -0.0034, 0.0006]
PARAMS = PyramidParams(n_features=500)
TPARAMS = TPyramidParams(n_features=500)
LAPPINGS = {"full": (0.0, float(W)), "partial": (100.0, 220.0)}
KEYS = ("kps", "octave", "angle", "response", "desc", "mono_index")


@pytest.fixture(scope="module")
def pair():
    cam = KannalaBrandt8(KB8)
    walls = tumvi_scene.world()
    tcw = tumvi_scene.pose(3.0).inverse()
    t_rl = SE3(np.eye(3), np.array([-BASELINE, 0.0, 0.0]))  # left coords -> right
    return render_world(walls, cam, tcw, H, W), render_world(walls, cam, t_rl * tcw, H, W)


def _pinned_reference(monkeypatch) -> None:
    """Trig pinned in both packages, the reference's stereo program jitted
    anew so that it traces the patched functions."""
    pin_trig_jit(monkeypatch)
    monkeypatch.setattr(
        jsf, "extract_and_match_stereo",
        jax.jit(jsf._extract_and_match_stereo_impl, static_argnums=(1, 2, 3)),
    )


def _both(pair, lapping):
    ref = jfe.extract_fisheye_pair(*pair, PARAMS, lapping, lapping)
    port = tfe.extract_fisheye_pair(*pair, TPARAMS, lapping, lapping, device="cpu")
    return port, ref


def _assert_integer_columns_equal(port, ref):
    for got, want in zip(port, ref):
        assert got.keys() == want.keys() == set(KEYS)
        for key in ("kps", "octave", "response", "mono_index"):
            g, w = np.asarray(got[key]), np.asarray(want[key])
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        assert len(got["kps"]) > 300


@pytest.mark.parametrize("lapping", sorted(LAPPINGS))
def test_extract_fisheye_pair_matches_reference(pair, lapping):
    port, ref = _both(pair, LAPPINGS[lapping])
    _assert_integer_columns_equal(port, ref)
    for got, want in zip(port, ref):
        n = len(got["kps"])
        assert 0 < got["mono_index"] < n if lapping == "partial" else got["mono_index"] == 0
        d = np.abs(got["angle"] - want["angle"])
        assert np.minimum(d, 360 - d).max() < 1e-3
        bits = np.unpackbits(got["desc"] ^ want["desc"], axis=1).sum(axis=1)
        assert int((bits > 0).sum()) <= max(5, n // 100)
        assert bits.max() <= 4


@pytest.mark.parametrize("lapping", sorted(LAPPINGS))
def test_extract_fisheye_pair_exact_with_pinned_trig(pair, lapping, monkeypatch):
    _pinned_reference(monkeypatch)
    port, ref = _both(pair, LAPPINGS[lapping])
    _assert_integer_columns_equal(port, ref)
    for got, want in zip(port, ref):
        for key in ("angle", "desc"):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("lapping", sorted(LAPPINGS))
def test_stereo_fisheye_matches_equal_reference(pair, lapping):
    """Both packages' matcher on the port's features, with their own
    cameras and native libraries: the same depths, matches and points."""
    fl, fr = tfe.extract_fisheye_pair(*pair, TPARAMS, *[LAPPINGS[lapping]] * 2, device="cpu")
    sigma2 = np.asarray(TPARAMS.scale_factors, np.float64) ** 2
    tlr = [BASELINE, 0.0, 0.0]
    got = tfe.compute_stereo_fisheye_matches(
        fl, fr, KannalaBrandt8(KB8), KannalaBrandt8(KB8), SE3(np.eye(3), np.array(tlr)), sigma2
    )
    want = jfe.compute_stereo_fisheye_matches(
        fl, fr, RefKB8(KB8), RefKB8(KB8), RefSE3(np.eye(3), np.array(tlr)), sigma2
    )
    for name, g, w in zip(("depth", "l2r", "r2l", "p3d_l"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got[1] >= 0).sum() > 20


def _systems(lapping):
    kw = dict(mbf=KB8[0] * BASELINE, sequential=True, max_frames=5, lapping1=lapping,
              lapping2=lapping)
    port = System(KannalaBrandt8(KB8), orb_params=TPARAMS, camera2=KannalaBrandt8(KB8),
                  Tlr=SE3(np.eye(3), np.array([BASELINE, 0.0, 0.0])), device="cpu", **kw)
    ref = RefSystem(RefKB8(KB8), orb_params=PARAMS, camera2=RefKB8(KB8),
                    Tlr=RefSE3(np.eye(3), np.array([BASELINE, 0.0, 0.0])), **kw)
    return port, ref


def test_system_fisheye_frame_matches_reference(pair, monkeypatch):
    """The fisheye frame dict of `track_stereo` (both cameras' keypoints,
    depths, matches, stereo points) equal to the reference's with trig
    pinned, and the map its first frame builds."""
    _pinned_reference(monkeypatch)
    port, ref = _systems(LAPPINGS["partial"])
    got, want = port._extract_stereo_fisheye(*pair), ref._extract_stereo_fisheye(*pair)
    assert got.keys() == want.keys()
    for key in got:
        if key in ("camera2", "Tlr"):
            continue
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert got["n_left"] < len(got["kps"]) and (got["left_to_right"] >= 0).sum() > 20
    poses = [s.track_stereo(*pair, 0.0) for s in (port, ref)]
    np.testing.assert_array_equal(poses[0].matrix(), poses[1].matrix())
    assert port.map_stats() == ref.map_stats() and port.map_stats()["n_map_points"] > 20


def test_prefetch_with_lapping_runs_the_pinhole_program(pair):
    """prefetch_stereo with lapping areas runs the pinhole packed program,
    as the reference's does: the handle's block equals it."""
    port, _ = _systems(LAPPINGS["full"])
    host, done, _, shape = port.prefetch_stereo(*pair)
    assert done is None and shape == (H, W)
    want = tsf.extract_and_match_stereo_packed(
        torch.from_numpy(np.stack(pair)), TPARAMS, KB8[0] * BASELINE, KB8[0]
    )
    np.testing.assert_array_equal(host, want.numpy())


@pytest.mark.cuda
def test_fisheye_pair_on_card_matches_cpu(pair):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py phase 14 runs this check on the H100")
    from orbslam3_tpu_torch import FusedKernels

    lap = LAPPINGS["partial"]
    cpu = tfe.extract_fisheye_pair(*pair, TPARAMS, lap, lap, device="cpu")
    for fused in (FusedKernels(), FusedKernels(True, True, True)):
        card = tfe.extract_fisheye_pair(*pair, TPARAMS, lap, lap, device="cuda", fused=fused)
        _assert_integer_columns_equal(card, cpu)
        for got, want in zip(card, cpu):
            bits = np.unpackbits(got["desc"] ^ want["desc"], axis=1).sum(axis=1)
            assert int((bits > 0).sum()) <= max(5, len(bits) // 100) and bits.max() <= 4


def _track_tumvi(sysm, seq) -> tuple[float, int]:
    """Track `seq` with its IMU: every frame OK, VI initialised; returns
    (ATE RMSE in m, map points observed by both cameras)."""
    from orbslam3_tpu_torch.utils.synth import ate_rmse

    est, gt = [], []
    for k, (il, ir, tcw, imu) in enumerate(seq):
        pose = sysm.track_stereo(il, ir, k / tumvi_scene.FPS, imu=imu)
        assert pose is not None and sysm.get_tracking_state().name == "OK", k
        est.append(pose)
        gt.append(tcw)
    m = sysm.atlas.get_current_map()
    assert m.imu_initialized
    both = sum(any(l >= 0 and r >= 0 for l, r in mp.observations.values())
               for mp in m.get_all_map_points())
    return ate_rmse(est, gt), both


@pytest.mark.slow
def test_tumvi_fisheye_inertial_e2e_port(tmp_path):
    """The port's System from the TUM-VI settings, cut to 288x384
    (`tumvi_scene.write_settings`), over 40 frames with IMU: every frame
    tracked, VI init, ATE under tests/test_tumvi_inertial.py's 1.2 cm, map
    points observed by both cameras."""
    path = tumvi_scene.write_settings(str(tmp_path), 288, 384)
    sysm = System.from_files(None, path, sensor=System.IMU_STEREO, device="cpu")
    assert sysm.lapping1 == (0.0, 383.0) and sysm.settings.height == 288
    ate, both = _track_tumvi(sysm, tumvi_scene.system_sequence(sysm, 40))
    assert ate < 0.012 and both > 100


@pytest.mark.slow
def test_tumvi_configuration_matches_reference(tmp_path):
    """chip_smoke.py phase 14's run on the CPU: TUM-VI's settings at
    512x512 through both packages' System.from_files, the same 40 frames
    and IMU.  Both track every frame and initialise, with the same ATE;
    the reference's (0.2945 cm) is the figure the smoke prints beside the
    card's."""
    path = tumvi_scene.write_settings(str(tmp_path))
    port = System.from_files(None, path, sensor=System.IMU_STEREO, device="cpu")
    ref = RefSystem.from_files(None, path, sensor=RefSystem.IMU_STEREO)
    seq = tumvi_scene.system_sequence(port, 40)
    (port_ate, port_both), (ref_ate, ref_both) = (_track_tumvi(s, seq) for s in (port, ref))
    print(f"TUM-VI 512x512 ATE RMSE: port {port_ate * 100:.4f} cm, reference "
          f"{ref_ate * 100:.4f} cm; map points seen by both cameras {port_both} / {ref_both}")
    assert round(ref_ate * 100, 4) == 0.2945
    assert abs(port_ate - ref_ate) < 1e-5 and port_both > 100
    assert port.map_stats() == ref.map_stats()
