"""The card's renderer held to a frozen numpy copy of the port's
render_world at a small size, on the CPU; the lap and its textures made
from the seed alone."""

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
        planes = _planes(cfg, 5, 4)
        seq = cfg["sequence"]
        kind = importlib.import_module(f"slambench.world.laps.{seq['kind']}")
        R, c = kind.poses(seq, [0, seq["frames"] // 3])
        h, w = 60, 96
        s = w / cfg["Camera.width"]
        intr = tuple(v * s for v in harness.intrinsics(cfg))
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
