"""The card's renderer held to a frozen numpy copy of the port's
render_world at a small size, on the CPU; the lap and its textures made
from the seed alone, its poses at whole and fractional frames."""

import importlib
import json

import numpy as np
import torch

from slambench import harness
from slambench.tests.numpy_render import PlaneWorld, render_world
from slambench.world.render import Plane, make_texture, render

CONFIGS = sorted((harness.HERE / "configs").glob("*.json"))


def _planes(cfg: dict, seed: int, shrink: int):
    gen = torch.Generator()
    gen.manual_seed(seed)
    out = []
    for p in cfg["world"]["planes"]:
        h, w = (max(64, d // shrink) for d in p["texture"])
        tex = make_texture(h, w, gen)
        scale = p["scale"] * p["texture"][1] / w
        out.append((tex, p["p0"], p["ex"], p["ey"], scale))
    return out


def test_renderer_equals_the_numpy_render_world():
    for path in CONFIGS:
        cfg = json.load(open(path))
        # the pinhole renderer's configurations: those whose sensor renders
        # through a pinhole's `intrinsics`; another camera model brings its
        # own renderer and its own test
        sensor = harness.sensor_of(cfg)
        if not hasattr(sensor, "intrinsics"):
            continue
        planes = _planes(cfg, 5, 4)
        seq = cfg["sequence"]
        kind = importlib.import_module(f"slambench.world.laps.{seq['kind']}")
        R, c = kind.poses(seq, [0, seq["frames"] // 3])
        h, w = 60, 96
        s = w / cfg["Camera.width"]
        intr = tuple(v * s for v in sensor.intrinsics(cfg))
        got = render([Plane(*p) for p in planes], intr, torch.from_numpy(R),
                      torch.from_numpy(c), h, w).numpy()
        worlds = [PlaneWorld(t.numpy(), *rest) for t, *rest in planes]
        for i in range(len(R)):
            want = render_world(worlds, intr, R[i], c[i], h, w)
            diff = np.abs(got[i].astype(int) - want.astype(int))
            assert diff.max() <= 1, path.name
            assert (diff > 0).mean() < 0.01, path.name
            assert want.std() > 10  # the frame sees textured planes, not sky


def test_textures_come_from_the_seed():
    def tex(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return make_texture(96, 160, gen, blobs=200)

    a, b, c = tex(2**31 + 7), tex(2**31 + 7), tex(2**31 + 8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.dtype == torch.uint8 and tuple(a.shape) == (96, 160)


def test_laps_close():
    for path in CONFIGS:
        seq = json.load(open(path))["sequence"]
        kind = importlib.import_module(f"slambench.world.laps.{seq['kind']}")
        R, c = kind.poses(seq, [0, seq["frames"]])
        assert np.allclose(R[0], R[1]) and np.allclose(c[0], c[1])
        assert np.allclose(np.linalg.det(kind.poses(seq, np.arange(0, seq["frames"], 7))[0]), 1.0)


def _angle(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """The rotation angle between each pair of rotations, in radians."""
    tr = np.einsum("nij,nij->n", Ra, Rb)  # trace(Ra^T Rb)
    return np.arccos(np.clip((tr - 1) / 2, -1.0, 1.0))


def test_laps_take_fractional_frames():
    """An IMU sensor samples the lap between frames: the pose at k + 0.5
    lies between those of k and k + 1, on the path and not at either end."""
    for path in CONFIGS:
        seq = json.load(open(path))["sequence"]
        kind = importlib.import_module(f"slambench.world.laps.{seq['kind']}")
        k = np.arange(0, seq["frames"], 3, dtype=np.float64)
        R0, c0 = kind.poses(seq, k)
        Rh, ch = kind.poses(seq, k + 0.5)
        R1, c1 = kind.poses(seq, k + 1)
        step = np.linalg.norm(c1 - c0, axis=1)
        to0, to1 = np.linalg.norm(ch - c0, axis=1), np.linalg.norm(ch - c1, axis=1)
        assert (step > 0).all()
        for d in (to0, to1):
            assert ((0.1 * step < d) & (d < step)).all(), path.name
        turn = _angle(R0, R1)
        for a in (_angle(R0, Rh), _angle(Rh, R1)):
            assert ((0.1 * turn < a) & (a < turn)).all(), path.name
        assert np.allclose(np.linalg.det(Rh), 1.0)
