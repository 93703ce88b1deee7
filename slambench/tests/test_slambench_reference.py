"""The plain reference held to the program's op-by-op front-end on the CPU
(bit for bit at a small flat geometry), and its bfloat16 control failing
the check."""

import numpy as np
import torch

from slambench import harness
from slambench.reference.frontend import OrbParams, StereoReference
from slambench.sensors import stereo
from slambench.world.laps import sweep
from slambench.world.render import Plane, make_texture, render

H, W, FEATURES = 240, 320, 600
FX = 200.0
MBF = FX * 0.11


def _lap(seed: int, n: int = 2) -> harness.Lap:
    """n stereo pairs of the cell's world, 40 lap frames apart, at H x W."""
    cfg = harness.config_of(harness.load_benchmark(), {"config": "euroc_stereo"})
    gen = torch.Generator()
    gen.manual_seed(seed)
    planes = [Plane(make_texture(*(d // 4 for d in p["texture"]), gen), p["p0"], p["ex"], p["ey"],
                    p["scale"] * 4) for p in cfg["world"]["planes"]]
    R, c = sweep.poses(cfg["sequence"], np.arange(0, 40 * n, 40))
    intr = (FX, FX, W / 2, H / 2)
    right = torch.from_numpy(c + R @ np.array([0.11, 0.0, 0.0]))
    Rt, ct = torch.from_numpy(R), torch.from_numpy(c)
    images = torch.stack([render(planes, intr, Rt, ct, H, W),
                          render(planes, intr, Rt, right, H, W)], dim=1)
    return harness.Lap(images.numpy(), R, c)


def _pairs(seed: int, n: int = 2) -> list:
    return list(torch.from_numpy(_lap(seed, n).images))


def test_reference_equals_the_programs_front_end_bit_for_bit():
    from orbslam3_tpu_torch.frontend.stereo_frame import StereoFrontEnd
    from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams

    fe = StereoFrontEnd.from_reference(PyramidParams(n_features=FEATURES), (H, W), MBF, FX)
    ref = StereoReference(OrbParams(FEATURES, 1.2, 8, 20, 7), (H, W), MBF, FX, "cpu")
    for pair in _pairs(11):
        got = fe.eager(pair).numpy()
        want = ref(pair).numpy()
        assert np.array_equal(got, want)
        assert (want[:, 5] > 0).sum() > FEATURES // 2 and (want[:, 7] > 0).sum() > 50
        assert stereo.features_differ(want, stereo.unpack(got)) == 0


def test_bfloat16_control_fails_the_feature_check():
    from slambench.control import control_checks
    from slambench.run import correct_of

    cfg = harness.config_of(harness.load_benchmark(), {"config": "euroc_stereo"})
    cfg.update({"Camera.width": W, "Camera.height": H, "ORBextractor.nFeatures": FEATURES,
                "Rectified.fx": FX, "Rectified.fy": FX, "Rectified.cx": W / 2,
                "Rectified.cy": H / 2, "Rectified.bf": MBF})
    lap = _lap(12, 3)
    checks, sound = control_checks(cfg, lap, [0, 1, 2], "cpu", 12)
    got = {name: (v, lim) for name, v, lim in checks}
    assert sound == 0
    assert got["features_differ"][0] > harness.FEATURE_LIMIT
    assert got["ate_m"][0] < 1e-9 and got["untracked_share"][0] == 0.0
    assert correct_of(checks) is False


def test_reference_refuses_a_geometry_that_is_not_flat():
    try:
        StereoReference(OrbParams(1000, 1.2, 8, 20, 7), (96, 128), MBF, FX, "cpu")
    except ValueError:
        return
    raise AssertionError("a 96x128 pair with 8 levels is not the flat geometry")
