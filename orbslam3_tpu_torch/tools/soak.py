"""Long-sequence soak run: full SLAM on the card at production geometry.

Renders an N-frame (default 400) looping sweep through the synthetic
textured world at EuRoC geometry (480x752, 8 levels, 1000 features),
drives the full System (threaded mapper + loop closing + vocabulary +
prefetch pipeline), and reports per-frame timing, tracked fraction, ATE,
and map health — scale evidence for the role the reference's committed
MH01 artifacts play (2250-frame run, 176 KFs; BASELINE.md).

Usage: python -m orbslam3_tpu_torch.tools.soak [n_frames] [pipe_depth]
           [--sequential] [--fps=F] [--device=cpu] [--workers=P]

The port's counterpart of the reference's tools/soak.py, on the port's
System and on the card unless --device=cpu is given; --workers=P renders
the synthetic frames in P processes (the same frames).
"""

import json
import os
import sys
import time
from collections import deque

import numpy as np

from orbslam3_tpu_torch.cameras.models import Pinhole
from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams
from orbslam3_tpu_torch.utils.lie import SE3, so3_exp
from orbslam3_tpu_torch.utils.synth import ate_rmse, make_world, render_world
from orbslam3_tpu_torch.vocab.vocabulary import BinaryVocabulary

SEED = 7  # the synthetic world's
_BLAS_THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def loop_pose(k: float, n: int) -> SE3:
    """Two laps of a wide sweep over n frames with slow vertical bob:
    revisits the start twice, exercising place recognition + covisibility
    reuse."""
    s = 2.0 * np.pi * k / (n / 2.0)
    t = np.array(
        [2.2 * np.sin(s), 0.05 * np.sin(0.37 * k), 0.35 * (1 - np.cos(s))]
    )
    yaw = -0.7 * np.sin(s)
    return SE3(so3_exp(np.array([0.0, yaw, 0.0])), t)


def _render_frames(args):
    """Frames `ks` of the soak's sequence (a worker's share)."""
    ks, n, camera, baseline, h, w = args
    walls = make_world(SEED)
    t_rl = SE3(np.eye(3), np.array([-baseline, 0.0, 0.0]))
    out = []
    for k in ks:
        tcw = loop_pose(k, n).inverse()
        out.append((render_world(walls, camera, tcw, h, w),
                    render_world(walls, camera, t_rl * tcw, h, w), tcw))
    return out


def render_sequence(n: int, camera, baseline: float, h: int, w: int, workers: int) -> list:
    """The frames of stereo_sequence(n, camera, baseline, h, w, seed=SEED,
    pose_fn=loop_pose), rendered by `workers` processes (each frame
    depends on the world and its pose only, so the frames are the same)."""
    if workers <= 1:
        return _render_frames((range(n), n, camera, baseline, h, w))
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    n_shares = 4 * workers  # progress is printed as shares finish
    shares = [list(range(i, n, n_shares)) for i in range(n_shares)]
    # one BLAS thread a worker (the workers inherit the environment): a
    # render's small products run slower on many threads, and P workers of
    # many threads each oversubscribe the host
    saved = {k: os.environ.get(k) for k in _BLAS_THREADS}
    os.environ.update({k: "1" for k in _BLAS_THREADS})
    try:
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            parts = []
            for part in pool.map(_render_frames,
                                 [(ks, n, camera, baseline, h, w) for ks in shares]):
                parts.append(part)
                print(f"rendered {sum(map(len, parts))}/{n} frames", flush=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    frames = [None] * n
    for ks, part in zip(shares, parts):
        for k, frame in zip(ks, part):
            frames[k] = frame
    return frames


def main(
    n: int = 400, depth: int = 4, sequential: bool = False, fps: float = 0.0,
    device: str = "cuda", workers: int = 1,
) -> dict:
    """fps > 0 paces playback at that camera rate, sleeping off any frame
    slack exactly like the reference's dataset drivers (stereo_euroc.cc
    main loop usleeps ttrack up to the inter-frame timestamp gap) — the
    mapper/loop threads get the slack the reference's design assumes.
    fps == 0 feeds flat out (a stress mode no camera produces)."""
    fx = 350.0
    h, w = 480, 752
    camera = Pinhole([fx, fx, w / 2, h / 2])
    baseline = 0.12
    mbf = fx * baseline
    from orbslam3_tpu_torch.slam.system import System

    t0 = time.time()
    frames = render_sequence(n, camera, baseline, h, w, workers)
    print(f"rendered {n} frames in {time.time()-t0:.1f}s", flush=True)

    sysm = System(camera, mbf, PyramidParams(n_features=1000), sequential=False, device=device)
    descs = [
        sysm._extract_stereo(frames[k][0], frames[k][1])["desc"]
        for k in range(0, n, max(n // 6, 1))
    ]
    voc = BinaryVocabulary.train(np.concatenate(descs), k=8, depth=3, seed=0)
    sysm.shutdown()
    sysm = System(
        camera, mbf, PyramidParams(n_features=1000),
        sequential=sequential, vocabulary=voc, device=device,
    )

    est, gt, times = [], [], []
    # per-frame forensics (VERDICT r4 weak #2): state + map identity every
    # frame, so dropped frames decompose into EPISODES with causes instead
    # of one aggregate count
    tracked = np.zeros(n, bool)
    states = []            # per-frame state names
    transitions = []       # (frame, old_state -> new_state, n_maps)
    last_state = None
    handles = deque(
        sysm.prefetch_stereo(frames[k][0], frames[k][1])
        for k in range(min(depth, n))
    )
    t_run = time.time()
    for kf in range(n):
        t1 = time.perf_counter()
        if kf + depth < n:
            handles.append(
                sysm.prefetch_stereo(frames[kf + depth][0], frames[kf + depth][1])
            )
        pose = sysm.track_stereo_prefetched(handles.popleft(), kf / 20.0)
        dt = (time.perf_counter() - t1) * 1e3
        if kf >= 10:
            times.append(dt)
        stname = sysm.get_tracking_state().name
        states.append(stname)
        if stname != last_state:
            transitions.append((kf, f"{last_state}->{stname}",
                                sysm.atlas.count_maps()))
            last_state = stname
        tracked[kf] = pose is not None
        if pose is not None:
            est.append(pose)
            gt.append(frames[kf][2])
        if fps > 0:
            slack = (kf + 1) / fps - (time.time() - t_run)
            if slack > 0:
                time.sleep(slack)
        if kf % 100 == 99:
            st = sysm.map_stats()
            print(
                f"frame {kf+1}: {stname} "
                f"KFs={st['n_keyframes']} MPs={st['n_map_points']} "
                f"maps={sysm.atlas.count_maps()} "
                f"median {np.median(times):.1f} ms",
                flush=True,
            )
    wall = time.time() - t_run
    sysm.shutdown()
    st = sysm.map_stats()
    rmse = ate_rmse(est, gt) if len(est) >= 2 else float("nan")
    # Post-hoc ATE over the REPLAYED trajectory (SaveTrajectory* semantics:
    # per-frame Tcr recomposed against final optimized KF poses, biggest
    # map).  The live per-frame log above keeps whatever coordinate frame
    # each pose was emitted in — a LOST->fork segment later welded back by
    # a map merge stays in the pre-merge frame there and poisons the
    # single-alignment ATE; the replay re-expresses it.
    traj = sysm.frame_trajectory(map_filter="biggest")
    gt_by_ts = {round(k / 20.0, 6): frames[k][2] for k in range(n)}
    est_r, gt_r = [], []
    for ts, twc in traj:
        g = gt_by_ts.get(round(ts, 6))
        if g is not None:
            est_r.append(twc.inverse())
            gt_r.append(g)
    rmse_replay = ate_rmse(est_r, gt_r) if len(est_r) >= 2 else float("nan")
    lm = sysm.local_mapper
    print(
        f"SOAK n={n} depth={depth}: tracked {int(tracked.sum())}/{n}, "
        f"ATE {rmse*1000:.2f} mm (replayed {rmse_replay*1000:.2f} mm over "
        f"{len(est_r)} frames), KFs={st['n_keyframes']} "
        f"MPs={st['n_map_points']}, maps={sysm.atlas.count_maps()}, "
        f"median {np.median(times):.2f} ms/frame, "
        f"p95 {np.percentile(times, 95):.1f} ms, wall {wall:.1f}s "
        f"({n/wall:.1f} fps), "
        f"LBA exec/abort {lm.n_lba_exec}/{lm.n_lba_abort}",
        flush=True,
    )
    result = {
        "metric": "soak",
        "n_frames": n,
        "mode": "sequential" if sequential else "threaded",
        "fps_paced": fps,
        "tracked": int(tracked.sum()),
        "ate_mm": round(rmse * 1000, 3),
        "ate_replay_mm": round(rmse_replay * 1000, 3),
        "replay_frames": len(est_r),
        "n_keyframes": st["n_keyframes"],
        "n_maps": sysm.atlas.count_maps(),
        "median_ms": round(float(np.median(times)), 2),
        "p95_ms": round(float(np.percentile(times, 95)), 1),
        "lba_exec": lm.n_lba_exec,
        "lba_abort": lm.n_lba_abort,
    }
    print(json.dumps(result), flush=True)
    # --- dropout episode report -----------------------------------------
    print("state transitions:", flush=True)
    for f0, tr, nm in transitions:
        print(f"  frame {f0:4d}: {tr} (maps={nm})", flush=True)
    drop = ~tracked
    edges = np.nonzero(np.diff(np.r_[0, drop.view(np.int8), 0]))[0]
    episodes = list(zip(edges[::2], edges[1::2]))  # [start, end) untracked
    print(f"dropout episodes: {len(episodes)}", flush=True)
    for a, b in episodes:
        span_states = sorted(set(states[a:b]))
        print(
            f"  frames {a}-{b-1} ({b-a} frames): states {span_states}",
            flush=True,
        )
    return result


if __name__ == "__main__":
    fps, device, workers = 0.0, "cuda", 1
    for a in sys.argv:
        if a.startswith("--fps="):
            fps = float(a.split("=", 1)[1])
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        if a.startswith("--workers="):
            workers = int(a.split("=", 1)[1])
    pos = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(
        int(pos[0]) if len(pos) > 0 else 400,
        int(pos[1]) if len(pos) > 1 else 4,
        sequential="--sequential" in sys.argv,
        fps=fps,
        device=device,
        workers=workers,
    )
