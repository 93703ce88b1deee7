"""Long-sequence soak run: full SLAM on the card at production geometry.

Renders an N-frame (default 400) looping sweep through the synthetic
textured world at EuRoC geometry (480x752, 8 levels, 1000 features),
drives the full System (threaded mapper + loop closing + vocabulary +
prefetch pipeline), and reports per-frame timing, tracked fraction, ATE,
and map health — scale evidence for the role the reference's committed
MH01 artifacts play (2250-frame run, 176 KFs; BASELINE.md).

Usage: python -m orbslam3_tpu_torch.tools.soak [n_frames] [pipe_depth]
           [--sequential] [--fps=F] [--device=cpu] [--workers=P]
           [--repeat=R]

The port's counterpart of the reference's tools/soak.py, on the port's
System and on the card unless --device=cpu is given; --workers=P renders
the synthetic frames in P processes (the same frames).  --repeat=R runs
the sequence R times on the frames rendered once, each run on a fresh
System (a threaded run's result varies with the threads' timing).  The
features each frame delivered to the tracker in the first run are held
against the front-end's eager program (`StereoFrontEnd.eager`, op by op)
on the same pair, bit for bit.

Besides the reference's report, each run prints the replayed ATE read
as the last frame is tracked (the back-end threads may still be at work)
and after `shutdown` (every thread ended), how long the shutdown waited,
the loops closed and maps merged, the tracked frames the replay lost
(with the keyframe and map their reference reaches), and the stretches
of frames whose replayed error stands out.  A run in which no frame is
tracked for WATCHDOG_S seconds prints every thread's stack and ends the
process.
"""

import faulthandler
import hashlib
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
WATCHDOG_S = 300  # a stop longer than this prints every thread's stack and ends the run
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


def aligned_errors(est: list, gt: list) -> np.ndarray:
    """Per-frame position error after the SE3 Umeyama alignment of
    `utils.synth.ate_rmse` (its RMSE is the root mean square of these)."""
    p_est = np.stack([T.inverse().t for T in est])
    p_gt = np.stack([T.inverse().t for T in gt])
    mu_e, mu_g = p_est.mean(0), p_gt.mean(0)
    u, _, vt = np.linalg.svd((p_gt - mu_g).T @ (p_est - mu_e) / len(p_est))
    s_mat = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s_mat[2, 2] = -1
    r = u @ s_mat @ vt
    aligned = (p_est - mu_e) @ r.T + mu_g
    return np.linalg.norm(aligned - p_gt, axis=1)


def replay(sysm, frames: list) -> tuple:
    """(replayed ATE in m, frame indices replayed, their aligned errors in
    m): SaveTrajectory semantics, per-frame Tcr recomposed against the
    final optimized KF poses of the biggest map.  The live per-frame log
    keeps whatever coordinate frame each pose was emitted in -- a
    LOST->fork segment later welded back by a map merge stays in the
    pre-merge frame there and poisons the single-alignment ATE; the replay
    re-expresses it."""
    index_by_ts = {round(k / 20.0, 6): k for k in range(len(frames))}
    ks, est = [], []
    for ts, twc in sysm.frame_trajectory(map_filter="biggest"):
        k = index_by_ts.get(round(ts, 6))
        if k is not None:
            ks.append(k)
            est.append(twc.inverse())
    if len(est) < 2:
        return float("nan"), ks, np.zeros(len(ks))
    gt = [frames[k][2] for k in ks]
    return ate_rmse(est, gt), ks, aligned_errors(est, gt)


def error_stretches(ks: list, err: np.ndarray, floor_m: float = 0.005) -> list:
    """[(first frame, last frame, frames, largest error in m)] of the runs
    of replayed frames whose error exceeds max(floor_m, 3 x the median),
    largest first (at most 8)."""
    if len(err) == 0:
        return []
    high = err > max(floor_m, 3.0 * float(np.median(err)))
    out, i = [], 0
    while i < len(ks):
        if not high[i]:
            i += 1
            continue
        j = i
        while j + 1 < len(ks) and high[j + 1]:
            j += 1
        out.append((ks[i], ks[j], j - i + 1, float(err[i : j + 1].max())))
        i = j + 1
    return sorted(out, key=lambda e: -e[3])[:8]


def replay_losses(sysm, frames: list, lost_frames: list) -> list:
    """[(reference keyframe id, its map's id, "live" / "retired", frames)]
    of the tracked frames the replay left out, grouped by the keyframe the
    replay reached from each frame's reference (culled ones walked up to
    their parent, as `System.frame_trajectory` does), in frame order."""
    index_by_ts = {round(k / 20.0, 6): k for k in range(len(frames))}
    want, live = set(lost_frames), set(map(id, sysm.atlas.get_all_maps()))
    groups: dict = {}
    for _fid, ts, _tcr, ref, lost in sysm.tracker.trajectory:
        k = index_by_ts.get(round(ts, 6))
        if k not in want:
            continue
        kf = ref
        while kf is not None and kf.bad and kf.parent is not None:
            kf = kf.parent
        if kf is None or kf.map is None or lost:
            key = (-1, -1, "logged lost" if lost else "no reference")
        else:
            key = (kf.id, kf.map.id, "live" if id(kf.map) in live else "retired")
        groups.setdefault(key, []).append(k)
    return [key + (ks,) for key, ks in sorted(groups.items(), key=lambda g: g[1][0])]


def _digest(host) -> bytes:
    return hashlib.blake2b(np.ascontiguousarray(host).tobytes(), digest_size=16).digest()


def check_against_eager(sysm, frames: list, delivered: dict) -> tuple:
    """(frames checked, frames whose delivered features differ from the
    front-end's eager program on the same pair)."""
    import torch

    fe = sysm._front_end(frames[0][0].shape)
    bad = []
    for k, got in sorted(delivered.items()):
        want = fe.eager(sysm._pair(frames[k][0], frames[k][1])).cpu().numpy()
        if _digest(want) != got:
            bad.append(k)
    if sysm.device.type == "cuda":
        torch.cuda.synchronize(sysm.device)
    return len(delivered), bad


def run_once(frames: list, camera, mbf: float, voc, depth: int, sequential: bool,
             fps: float, device: str, check: bool) -> dict:
    """One pass of the soak's sequence through a fresh System."""
    from orbslam3_tpu_torch.slam.system import System

    n = len(frames)
    sysm = System(
        camera, mbf, PyramidParams(n_features=1000),
        sequential=sequential, vocabulary=voc, device=device,
    )

    est, gt, times = [], [], []
    delivered = {}  # frame -> digest of the features the tracker read
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
        faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
        t1 = time.perf_counter()
        if kf + depth < n:
            handles.append(
                sysm.prefetch_stereo(frames[kf + depth][0], frames[kf + depth][1])
            )
        handle = handles.popleft()
        pose = sysm.track_stereo_prefetched(handle, kf / 20.0)
        dt = (time.perf_counter() - t1) * 1e3
        if check:
            delivered[kf] = _digest(np.asarray(handle[0]))
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
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    rmse_live_replay, _, _ = replay(sysm, frames)  # threads may still be at work
    t_shut = time.perf_counter()
    sysm.shutdown()
    shutdown_s = time.perf_counter() - t_shut
    faulthandler.cancel_dump_traceback_later()
    st = sysm.map_stats()
    rmse = ate_rmse(est, gt) if len(est) >= 2 else float("nan")
    rmse_replay, ks, err = replay(sysm, frames)
    lost_in_replay = sorted(set(np.nonzero(tracked)[0].tolist()) - set(ks))
    lm, lc = sysm.local_mapper, sysm.loop_closer
    print(
        f"SOAK n={n} depth={depth}: tracked {int(tracked.sum())}/{n}, "
        f"ATE {rmse*1000:.2f} mm (replayed {rmse_replay*1000:.2f} mm over "
        f"{len(ks)} frames), KFs={st['n_keyframes']} "
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
        "replay_frames": len(ks),
        "n_keyframes": st["n_keyframes"],
        "n_maps": sysm.atlas.count_maps(),
        "median_ms": round(float(np.median(times)), 2),
        "p95_ms": round(float(np.percentile(times, 95)), 1),
        "lba_exec": lm.n_lba_exec,
        "lba_abort": lm.n_lba_abort,
        "ate_replay_before_shutdown_mm": round(rmse_live_replay * 1000, 3),
        "shutdown_s": round(shutdown_s, 3),
        "loops_closed": lc.n_loops_closed if lc is not None else 0,
        "maps_merged": getattr(lc, "n_merges", 0),
        "tracked_not_replayed": lost_in_replay[:20],
        "n_tracked_not_replayed": len(lost_in_replay),
    }
    print(json.dumps(result), flush=True)
    if lost_in_replay:
        print("tracked frames not replayed, by the keyframe their reference reaches:",
              flush=True)
        for kf_id, map_id, state, lost_ks in replay_losses(sysm, frames, lost_in_replay):
            print(f"  keyframe {kf_id} of map {map_id} ({state}): {len(lost_ks)} frames "
                  f"{lost_ks[0]}-{lost_ks[-1]}", flush=True)
    print("replayed error stretches (first-last frame, frames, largest mm):", flush=True)
    for a, b, count, emax in error_stretches(ks, err):
        print(f"  frames {a}-{b} ({count} frames): {emax*1000:.2f} mm", flush=True)
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
    if check:
        n_checked, differ = check_against_eager(sysm, frames, delivered)
        result["frames_checked_against_eager"] = n_checked
        result["frames_differing_from_eager"] = differ[:20]
        print(json.dumps({k: result[k] for k in ("frames_checked_against_eager",
                                                  "frames_differing_from_eager")}), flush=True)
    return result


def main(
    n: int = 400, depth: int = 4, sequential: bool = False, fps: float = 0.0,
    device: str = "cuda", workers: int = 1, repeat: int = 1,
) -> list:
    """fps > 0 paces playback at that camera rate, sleeping off any frame
    slack exactly like the reference's dataset drivers (stereo_euroc.cc
    main loop usleeps ttrack up to the inter-frame timestamp gap) — the
    mapper/loop threads get the slack the reference's design assumes.
    fps == 0 feeds flat out (a stress mode no camera produces).  Returns
    one result a run."""
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
    results = []
    for r in range(repeat):
        if repeat > 1:
            print(f"run {r + 1}/{repeat}", flush=True)
        results.append(run_once(frames, camera, mbf, voc, depth, sequential, fps, device,
                                check=r == 0))
    return results


if __name__ == "__main__":
    fps, device, workers, repeat = 0.0, "cuda", 1, 1
    for a in sys.argv:
        if a.startswith("--fps="):
            fps = float(a.split("=", 1)[1])
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        if a.startswith("--workers="):
            workers = int(a.split("=", 1)[1])
        if a.startswith("--repeat="):
            repeat = int(a.split("=", 1)[1])
    pos = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(
        int(pos[0]) if len(pos) > 0 else 400,
        int(pos[1]) if len(pos) > 1 else 4,
        sequential="--sequential" in sys.argv,
        fps=fps,
        device=device,
        workers=workers,
        repeat=repeat,
    )
