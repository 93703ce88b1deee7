"""The threaded soak of two trees in turns, on one rendering of its frames.

A threaded soak's result varies with the threads' timing, so comparing
two trees takes several runs of each, in turns, on the same frames.  This
renders the soak's 2250 frames (`tools/soak.render_sequence`) once into
three `.npy` files, then runs `soak.run_once` once per turn, each in a
process of its own whose `PYTHONPATH` is that turn's tree (the same
package name in both), and prints each run's result line with its error
stretches and the tracked frames its replay left out.  With --diag each
run also prints, for every map merge, the frame the tracker was on and
the keyframes merged, and for the frames of the largest replayed errors,
those left out and those just after a merge: the reference keyframe,
whether it is culled, the keyframe the replay reaches from it, that
keyframe's map and whether the map still holds it, and |tcr.t|.

Usage:
  python -m orbslam3_tpu_torch.tools.soak_ab TREE_A [TREE_B] [--runs=R]
      [--sequential] [--diag] [--frames=N] [--workers=P] [--device=cpu]
(turns A, B, A, B, ...; --sequential adds one sequential run of the
last tree; logs under chiprun_out/soak_ab/ of the current directory, the
rendered frames in .scratch/ of this tool's checkout until the end)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

FX, H, W, BASELINE = 350.0, 480, 752, 0.12


def render(n: int, workers: int, prefix: str) -> None:
    from orbslam3_tpu_torch.cameras.models import Pinhole
    from orbslam3_tpu_torch.tools import soak

    t0 = time.time()
    frames = soak.render_sequence(n, Pinhole([FX, FX, W / 2, H / 2]), BASELINE, H, W, workers)
    np.save(prefix + "_img.npy", np.stack([np.stack([l, r]) for l, r, _ in frames]))
    np.save(prefix + "_R.npy", np.stack([t.R for _, _, t in frames]))
    np.save(prefix + "_t.npy", np.stack([t.t for _, _, t in frames]))
    print(f"rendered {n} frames in {time.time() - t0:.1f} s", flush=True)


def _diagnose(merges: list) -> tuple:
    """Hooks that record each merge and keep the System and the replayed
    errors of the run: (install, the records)."""
    from orbslam3_tpu_torch.slam import loop_closing
    from orbslam3_tpu_torch.slam import system as system_mod
    from orbslam3_tpu_torch.tools import soak

    held: dict = {}
    merge_maps, init, stretches = (loop_closing.LoopClosing.merge_maps,
                                   system_mod.System.__init__, soak.error_stretches)

    def merge_hook(self, kf_cur, kf_match, s):
        cur = held["sys"].tracker.current
        young = [k.id for k in kf_cur.map.get_all_keyframes()]
        merges.append(dict(frame=None if cur is None else round(cur.timestamp * 20),
                           kf_cur=kf_cur.id, kf_match=kf_match.id, young_map=kf_cur.map.id,
                           old_map=kf_match.map.id, young_kfs=[min(young), max(young), len(young)]))
        return merge_maps(self, kf_cur, kf_match, s)

    def init_hook(self, *a, **k):
        init(self, *a, **k)
        held["sys"] = self

    def stretches_hook(ks, err, floor_m=0.005):
        held["err"] = dict(zip(ks, np.asarray(err)))
        return stretches(ks, err, floor_m)

    def install():
        loop_closing.LoopClosing.merge_maps = merge_hook
        system_mod.System.__init__ = init_hook
        soak.error_stretches = stretches_hook

    return install, held


def _print_frames(sysm, err: dict, merges: list, left_out: list) -> None:
    want = set(sorted(err, key=lambda k: -err[k])[:40]) | set(left_out)
    want |= {k for m in merges if m["frame"] is not None for k in range(m["frame"] - 3, m["frame"] + 30)}
    for _fid, ts, tcr, ref, lost in sysm.tracker.trajectory:
        k = round(ts * 20)
        if k not in want:
            continue
        kf = ref
        while kf is not None and kf.bad and kf.parent is not None:
            kf = kf.parent
        print("DIAG " + json.dumps(dict(
            frame=k, err_mm=None if k not in err else round(float(err[k]) * 1e3, 2), lost=lost,
            ref=None if ref is None else ref.id, ref_bad=None if ref is None else ref.bad,
            reached=None if kf is None else kf.id, reached_bad=None if kf is None else kf.bad,
            reached_map=None if kf is None or kf.map is None else kf.map.id,
            in_map=None if kf is None or kf.map is None else kf in kf.map.keyframes,
            tcr_t=round(float(np.linalg.norm(tcr.t)), 3))), flush=True)


def run(prefix: str, mode: str, fps: float, device: str, diag: bool) -> None:
    """One soak run of the tree on `sys.path` over the rendered frames."""
    from orbslam3_tpu_torch.cameras.models import Pinhole
    from orbslam3_tpu_torch.oracle.orb_cpu import PyramidParams
    from orbslam3_tpu_torch.slam.system import System
    from orbslam3_tpu_torch.tools import soak
    from orbslam3_tpu_torch.utils.lie import SE3
    from orbslam3_tpu_torch.vocab.vocabulary import BinaryVocabulary

    img = np.load(prefix + "_img.npy")
    rot, trans = np.load(prefix + "_R.npy"), np.load(prefix + "_t.npy")
    frames = [(img[k, 0], img[k, 1], SE3(rot[k], trans[k])) for k in range(len(img))]
    n = len(frames)
    camera = Pinhole([FX, FX, W / 2, H / 2])
    # the soak's vocabulary, trained as `soak.main` trains it
    sysm = System(camera, FX * BASELINE, PyramidParams(n_features=1000), sequential=False,
                  device=device)
    descs = [sysm._extract_stereo(frames[k][0], frames[k][1])["desc"]
             for k in range(0, n, max(n // 6, 1))]
    voc = BinaryVocabulary.train(np.concatenate(descs), k=8, depth=3, seed=0)
    sysm.shutdown()
    merges: list = []
    if diag:
        install, held = _diagnose(merges)
        install()
    result = soak.run_once(frames, camera, FX * BASELINE, voc, 4, mode == "sequential", fps,
                           device, check=False)
    print("RESULT " + json.dumps(result), flush=True)
    if diag:
        print("DIAG merges " + json.dumps(merges), flush=True)
        _print_frames(held["sys"], held.get("err", {}), merges,
                      result.get("tracked_not_replayed", []))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opt = {a.split("=", 1)[0]: (a.split("=", 1) + [""])[1] for a in argv if a.startswith("--")}
    if argv and argv[0] == "--render":
        render(int(argv[1]), int(argv[2]), argv[3])
        return 0
    if argv and argv[0] == "--run":
        run(argv[1], argv[2], float(argv[3]), argv[4], argv[5] == "diag")
        return 0
    trees = [os.path.abspath(a) for a in argv if not a.startswith("--")]
    if not 1 <= len(trees) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    runs = int(opt.get("--runs") or 5)
    device = opt.get("--device") or "cuda"
    out = os.path.join(os.getcwd(), "chiprun_out", "soak_ab")
    os.makedirs(out, exist_ok=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.makedirs(os.path.join(here, ".scratch"), exist_ok=True)
    prefix = os.path.join(here, ".scratch", "soak_ab_frames")  # ~1.6 GB, removed at the end
    subprocess.run([sys.executable, "-m", "orbslam3_tpu_torch.tools.soak_ab", "--render",
                    opt.get("--frames") or "2250", opt.get("--workers") or "8", prefix],
                   check=True, env=dict(os.environ, PYTHONPATH=here))
    turns = [(t, "threaded", "20") for _ in range(runs) for t in trees]
    if "--sequential" in opt:
        turns.append((trees[-1], "sequential", "0"))
    try:
        for i, (tree, mode, fps) in enumerate(turns):
            log = os.path.join(out, f"{i:02d}_{os.path.basename(tree)}_{mode}.log")
            t0 = time.time()
            with open(log, "w") as f:
                proc = subprocess.run(
                    # this file by its path: the tree's own package (its
                    # PYTHONPATH) runs under this tool's driver
                    [sys.executable, "-X", "faulthandler", os.path.abspath(__file__),
                     "--run", prefix, mode, fps, device, "diag" if "--diag" in opt else "-"],
                    stdout=f, stderr=subprocess.STDOUT, cwd=tree, timeout=1200,
                    env=dict(os.environ, PYTHONPATH=tree))
            print(json.dumps(dict(turn=i, tree=tree, mode=mode, rc=proc.returncode,
                                  s=round(time.time() - t0, 1))), flush=True)
            for line in open(log).read().splitlines():
                if line.startswith(("RESULT", "DIAG merges", "SOAK", "  frames ", "  keyframe ",
                                    "tracked frames not")) or "replayed error" in line:
                    print("   " + line[:1500], flush=True)
    finally:
        for ext in ("_img.npy", "_R.npy", "_t.npy"):
            if os.path.exists(prefix + ext):
                os.remove(prefix + ext)
    return 0


if __name__ == "__main__":
    sys.exit(main())
