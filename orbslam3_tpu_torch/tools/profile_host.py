"""cProfile of the host tracking loop on the fabricated-feature world.

The port's counterpart of the reference's `tools/profile_host.py`: a
synthetic point world (6000 points with random descriptors) seen along a
smooth sweep, its exact projections fed to `System.track_stereo_features`
(no image, no front-end), so the profile holds the host back-end alone:
the tracking state machine, the keyframe policy, local mapping, culling,
the native matchers and the pose optimiser.  The world, the sweep and the
constants are the reference test's (`tests/test_fabricated_e2e.py`),
copied here: the package imports nothing from the tests.

Usage: python -m orbslam3_tpu_torch.tools.profile_host [--plain] [--frames=N]
           [--device=cpu]
(--plain: the timing line alone, no profile)
"""

from __future__ import annotations

import cProfile
import pstats
import sys
import time

import numpy as np

from orbslam3_tpu_torch.cameras.models import Pinhole
from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams
from orbslam3_tpu_torch.slam.system import System
from orbslam3_tpu_torch.utils.lie import SE3, so3_exp

CAM = Pinhole([350.0, 350.0, 256.0, 192.0])
W, H = 512, 384
MBF = 42.0
N_FRAMES = 200


def _world(seed=0, n=6000):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)) * [8, 4, 4] + [0, 0, 8]
    descs = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    return pts, descs, rng


# Fixed per-point detection priority: a real detector ranks by corner
# response, so consecutive frames see (mostly) the SAME subset of the
# visible points.
_PRIORITY = np.random.default_rng(99).permutation(6000)


def _feats_at(pts, descs, rng, Tcw, n_max=800, noise=0.25):
    pc = pts @ Tcw.R.T + Tcw.t
    vis = pc[:, 2] > 0.5
    uv_all = CAM.project(np.where(vis[:, None], pc, [0, 0, 1.0]))
    ok = vis & (uv_all[:, 0] > 10) & (uv_all[:, 0] < W - 10) \
        & (uv_all[:, 1] > 10) & (uv_all[:, 1] < H - 10)
    sel = np.nonzero(ok)[0]
    if len(sel) > n_max:
        sel = sel[np.argsort(_PRIORITY[sel], kind="stable")[:n_max]]
        sel.sort()
    uv = uv_all[sel] + rng.normal(0, noise, (len(sel), 2))
    z = pc[sel, 2]
    return dict(
        kps=uv,
        octave=np.zeros(len(sel), np.int32),
        angle=np.zeros(len(sel), np.float32),
        response=np.ones(len(sel), np.float32),
        desc=descs[sel],
        u_right=uv[:, 0] - MBF / z + rng.normal(0, noise, len(sel)),
        depth=z,
    )


def _pose(k):
    """Smooth bounded sweep with revisits across 10 s."""
    s = k * 0.05
    t = np.array([
        2.0 * np.sin(0.25 * s * np.pi),
        0.1 * np.sin(0.4 * k / 4),
        0.8 * np.sin(0.15 * s * np.pi),
    ])
    w = np.array([0.02 * np.sin(0.1 * k), -0.9 * np.sin(0.2 * s * np.pi), 0.0])
    return SE3(so3_exp(w), t).inverse()


def run(n_frames: int = N_FRAMES, device: str = "cuda") -> tuple:
    """(frames, seconds, the System after the run)."""
    pts, descs, rng = _world()
    sysm = System(CAM, MBF, PyramidParams(n_features=800),
                  sequential=True, max_frames=6, device=device)
    t0 = time.perf_counter()
    for k in range(n_frames):
        feats = _feats_at(pts, descs, rng, _pose(k))
        sysm.track_stereo_features(feats, k / 20.0, (0, 0, W, H))
    dt = time.perf_counter() - t0
    print(f"{n_frames} frames in {dt:.2f}s = {dt / n_frames * 1e3:.1f} ms/frame", flush=True)
    return n_frames, dt, sysm


def main(argv=None) -> int:
    from orbslam3_tpu_torch.tools.card import open_device

    argv = sys.argv[1:] if argv is None else argv
    device = next((a.split("=", 1)[1] for a in argv if a.startswith("--device=")), "cuda")
    n = int(next((a.split("=", 1)[1] for a in argv if a.startswith("--frames=")), N_FRAMES))
    if open_device("profile_host", device) is None:
        return 1
    if "--plain" in argv:
        run(n, device)[2].shutdown()
        return 0
    prof = cProfile.Profile()
    prof.enable()
    _, _, sysm = run(n, device)
    prof.disable()
    sysm.shutdown()
    st = pstats.Stats(prof, stream=sys.stdout)
    st.sort_stats("cumulative").print_stats(28)
    return 0


if __name__ == "__main__":
    sys.exit(main())
