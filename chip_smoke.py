"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:
  1. require CUDA and print the card (name, power limit);
  2. build the hand-written kernels from orbslam3_tpu_torch/csrc;
  3. each kernel against its plain PyTorch twin on the card, bit-exact, at
     the shapes of the main path (752x480 stereo, 8 levels, 1000 features),
     with both times from CUDA events (per call, and as device time over
     the replay of a CUDA graph of 20 calls); B1 also on an odd 97x211
     image and on the images that take the FAST score to the ends of its
     range (orbslam3_tpu_torch/tools/score_extremes.py), odd widths that
     leave a partial 4-pixel group among them; B2 as a stereo frame
     launches it (two launches of two jobs each: the orientation + BRIEF
     windows, the left + right SAD strips) and each of the four shapes
     alone, then at the edge cases of
     orbslam3_tpu_torch/tools/bench_window_kernels.py (an image's last byte
     with h*w % 4 != 0, views 1-3 bytes past an aligned base, K = 1 and K
     not a multiple of a block's windows, windows under 4 columns, 48x128
     and larger windows, two jobs of different shapes in one launch, two
     jobs whose grids differ by 2^20 blocks); and the launch floor, one
     in-place add on one element in the same CUDA-graph harness;
  4. the stereo tracking path through its entry points: System.track_stereo
     over a 30-frame synthetic sequence, save_trajectory_tum, shutdown —
     every frame tracked, ATE RMSE under 1 cm, one B1 and two B2 launches
     per frame, and no JAX in the process;
  5. the whole front-end on the card against the same code on the CPU;
  6. torch.profiler: the front-end's device-busy time per frame by device
     op (full table in chiprun_out/chip_smoke_profile.txt), and the
     device-busy share of whole track_stereo frames;
  7. the fused kernels B3, B4 and both modes of B5 against their plain
     twins on the card, bit-exact, at the shapes of the mono / RGB-D path
     (detection composites of one and two cameras, 1000 / 2000 / 5000
     orientation windows, 1000 / 5000 BRIEF samplings), with device times;
     B3 also at thresholds the path never uses (min_th <= 0, ini_th > 254)
     on the extremes' images and the mono composite; B4 and B5 also at the
     window kernels' edge cases (tools/bench_window_kernels.py), other
     window shapes up to 48x128 among them; B5's index mode (the TPU
     kernel's function) at K = 1000 / 5000, its launches counted over this
     check pass; B5's rBRIEF mode (the whole fused brief_descriptors) at
     K = 1000 / 5000 with (cos, sin) pinned, bit-exact, and with the trig
     in the kernel, the descriptors that differ from the twin's (torch.cos
     / torch.sin) counted and printed;
  8. System.track_monocular over every second frame of the sequence under
     FusedKernels(True, True, True) (the 5x init extractor takes 5000
     features): tracking OK, >= 6 poses, Sim3 ATE under 5 cm, one B3, one
     B4 and one B5 rBRIEF launch per frame, and no B1, B2 or B5 index
     launch;
  9. System.track_rgbd over a 30-frame synthetic RGB-D sequence under the
     same configuration: every frame tracked, ATE under 1 cm, the same
     launch counts;
 10. fused against default on one frame: the stereo front-end's and the
     mono extractor's packed outputs equal column for column;
 11. torch.profiler: the stereo and mono front-ends' device-busy time and
     device ops per frame, default and fused side by side;
 12. the A/B harness of the FAST-score variants T1-T4
     (orbslam3_tpu_torch.tools.bench_fast_variants): its check pass, every
     case of the four TPU harnesses on the 2112x736 harness image and the
     3264x736 stereo detection composite bit-exact against the plain
     versions, with the launches counted; every case again on an odd 97x211
     image (partial tiles, the packed kernel's odd-width tail), bit-exact,
     the tiles whose u16 halo needs more than 48 KB of shared memory (T3
     s48 c768 and s64 c384, T4 s48 c768) among them; then the harness's
     timing pass (device time and bound per case) and each function's
     default case against its plain version, both timed;
 13. the dense SearchByProjection matcher that tracking runs on the
     System's device at >= 30000 local-map candidates
     (ops/matching.search_by_projection_batch), at 30000 map points x 1000
     keypoints, on the card against the CPU: integers equal, card time.

Phase 2 also requires the port's native host library to build
(`native.available()`).  Last, no module of JAX or of the JAX package may
be loaded.  The line before last is the JSON kernel report (launches:
phase 4's for B1 and B2, phases 8 and 9's for B3, B4 and B5's rBRIEF mode,
phase 7's check pass for B5's index mode and phase 12's for T1-T4, which
no tracking path runs; bounds computed from this run's shapes and, for the
window kernels B2, B4 and B5, from the distinct image bytes this run's
windows cover or its picks read), the last line the JSON result.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from orbslam3_tpu_torch.utils.device_time import (
    F32_NO_FMA_OPS_PER_S,
    FAST_SCORE_OPS_PER_PX,
    INT16X2_OPS_PER_S,
    NO_TRACE,
    bound_ms,
    cuda_ms,
    device_ms,
    device_profile,
)

H, W = 480, 752
FX = 435.2
BASELINE = 0.11
N_FRAMES = 30
SEED = 1

# the least integer ops per pixel of B1's function, all in 16-bit lanes:
# the FAST score and the mask; B3's adds the two thresholds, the tile's
# choice and the 3x3 NMS
B1_OPS_PER_PX = FAST_SCORE_OPS_PER_PX + 1
B3_OPS_PER_PX = B1_OPS_PER_PX + 2 + 2 + 9
# the dense matcher's inputs: map points x frame keypoints
MATCH_M, MATCH_K = 30000, 1000
# the tracking paths launch none of the A/B variants T1-T4
NO_T_LAUNCHES = {f"fast_variant_t{i}": 0 for i in range(1, 5)}
# the least operations of one keypoint's rBRIEF descriptor: per pattern
# point 4 multiplies, 2 adds and 2 roundings, then 256 compares; each
# product and sum is rounded on its own (no FMA), so they count at
# F32_NO_FMA_OPS_PER_S
BRIEF_OPS_PER_KP = 512 * (4 + 2 + 2) + 256


def phase(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def kernel_vs_twin(label: str, kernel_fn, twin_fn) -> tuple[float, float, float]:
    """(max abs err, kernel device ms, twin device ms) of a wrapper call
    against its plain twin on the same card tensors; fails unless equal."""
    got, want = kernel_fn(), twin_fn()
    torch.cuda.synchronize()
    if isinstance(got, tuple):
        got, want = torch.stack(got), torch.stack(want)
    err = max_abs_err(got, want)
    require(err == 0, f"{label}: kernel != twin (max abs err {err})")
    kdev, pdev = device_ms(kernel_fn), device_ms(twin_fn)
    phase(f"7 {label}: bit-exact, device time kernel {kdev:.4f} ms, twin {pdev:.4f} ms")
    return err, kdev, pdev


def run_entry_point(name: str, system, steps, tag: str, port, bench) -> dict:
    """Drive one entry point over `steps` ((call, ground-truth pose) pairs),
    the kernel counts set to 0 just before and read just after."""
    bench.records.pop(tag, None)
    port.reset_kernel_launches()
    est, gt, states, wall = [], [], [], []
    for call, tcw_gt in steps:
        t0 = time.perf_counter()
        pose = call()
        wall.append((time.perf_counter() - t0) * 1e3)
        states.append(system.get_tracking_state())
        if pose is not None:
            est.append(pose)
            gt.append(tcw_gt)
    launches = port.kernel_launches()
    stats = system.map_stats()
    system.shutdown()
    fe_ms = bench.records[tag]
    phase(f"{name} ms/frame: wall median {statistics.median(wall):.4f} (after frame 0 "
          f"{statistics.median(wall[1:]):.4f}, first {wall[0]:.4f}); front-end stream window "
          f"median {statistics.median(fe_ms):.4f} (after frame 0 "
          f"{statistics.median(fe_ms[1:]):.4f}, first {fe_ms[0]:.4f})")
    phase(f"{name} kernel launches in the run: {launches}; map {stats}")
    return dict(est=est, gt=gt, states=states, launches=launches, n=len(steps))


def matcher_inputs(m: int, k: int) -> list:
    """Numpy inputs of search_by_projection_batch, from SEED: map-point
    descriptors copied from keypoints with a bit flipped, many from the
    same keypoint, and duplicated keypoints, so distances tie."""
    rng = np.random.default_rng(SEED)
    kp_desc = rng.integers(0, 256, (k, 32), dtype=np.uint8)
    src = rng.integers(0, k // 6, m)
    mp_desc = kp_desc[src].copy()
    flip = rng.integers(0, 32, m)
    mp_desc[np.arange(m), flip] ^= np.uint8(1) << rng.integers(0, 8, m).astype(np.uint8)
    kp_desc[k // 2 :] = kp_desc[: k - k // 2]
    kp_xy = rng.uniform(0, W, (k, 2)).astype(np.float32)
    kp_xy[k // 2 :] = kp_xy[: k - k // 2]
    proj = (kp_xy[src] + rng.normal(0, 3, (m, 2))).astype(np.float32)
    return [
        proj, rng.integers(0, 8, m).astype(np.int32), rng.uniform(2, 30, m).astype(np.float32),
        mp_desc, rng.random(m) < 0.9,
        kp_xy, rng.integers(0, 8, k).astype(np.int32), kp_desc, rng.random(k) < 0.9,
    ]


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a GPU",
              file=sys.stderr)
        return 1
    # the port, imported only once a card is known to be present
    import orbslam3_tpu_torch as port
    from orbslam3_tpu_torch import _build
    from orbslam3_tpu_torch.frontend import stereo_frame as sf
    from orbslam3_tpu_torch.ops import extractor as ex
    from orbslam3_tpu_torch.ops import brief as tb, fast, pyramid, window_gather as wg
    from orbslam3_tpu_torch.tools import bench_score_kernels as bsk
    from orbslam3_tpu_torch.tools import bench_window_kernels as bwk
    from orbslam3_tpu_torch.slam.system import (
        FRONT_END_STREAM_TAG,
        MONO_STREAM_TAG,
        RGBD_STREAM_TAG,
        System,
    )
    from orbslam3_tpu_torch.utils.benchmark import Benchmark

    dev = torch.device("cuda")
    # phase 1 -------------------------------------------------------------
    card = card_line()
    phase(f"1 device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    # phase 2 -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.kernels()
    phase(f"2 built {_build.library_path().name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_info['seconds']:.2f} s)")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            phase("  ptxas: " + line.strip())
    from orbslam3_tpu_torch import native

    phase(f"2 native host library (g++): native.available() = {native.available()}")
    require(native.available(), "the port's native host library did not build")

    # phase 3 -------------------------------------------------------------
    camera = port.Pinhole([FX, FX, W / 2, H / 2])
    frames = port.stereo_sequence(N_FRAMES, camera, BASELINE, H, W, seed=SEED)
    params = port.PyramidParams()
    mbf = FX * BASELINE
    # the main path's front-end: its constant tables on the card
    fe = sf.front_end(params, (H, W), mbf, FX, "cuda")
    pair = torch.from_numpy(np.stack(frames[0][:2])).to(dev)
    pyrs = [pyramid.build_pyramid(pair[i], params, fe.resize_taps()) for i in range(2)]
    crops = [c for p in pyrs for c in ex.detection_crops(p, params)[1]]
    comp, _, _ = fast.detection_composite(crops)
    report = {}

    # the wrappers the main path calls, on card tensors; their launch
    # counts are set to 0 before phase 4
    def b1_case(name, img, m):
        got = fast.raw_score_map(img, m)
        want = fast.raw_score_map_plain(img, m)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"B1 {name}: kernel != twin (max abs err {err})")
        ms = cuda_ms(lambda: fast.raw_score_map(img, m))
        plain = cuda_ms(lambda: fast.raw_score_map_plain(img, m))
        kdev = device_ms(lambda: fast.raw_score_map(img, m))
        pdev = device_ms(lambda: fast.raw_score_map_plain(img, m))
        phase(f"3 B1 {name} {tuple(img.shape)}: bit-exact, median per call (events) kernel "
              f"{ms:.4f} ms, twin {plain:.4f} ms; device time kernel {kdev:.4f} ms, "
              f"twin {pdev:.4f} ms")
        return err, kdev, pdev

    err, ms, plain = b1_case("detection composite", comp, fe.det_mask)
    n_px = comp.numel()
    # img + mask read, int32 written
    bound, bound_by = bound_ms(6 * n_px, B1_OPS_PER_PX * n_px, INT16X2_OPS_PER_S)
    report["fast_score"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                                bound_by=bound_by, library_ms=None)
    odd = torch.randint(0, 256, (97, 211), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(SEED)).to(dev)
    err_odd, _, _ = b1_case("odd size, frame test", odd, None)
    # the score's extremes, with the seam mask and without; odd widths
    # leave a partial 4-pixel group
    errs = bsk.b1_extreme_errs(dev)
    bad = {k: e for k, e in errs.items() if e != 0}
    require(not bad, f"B1 kernel != twin at the score's extremes: {bad}")
    phase(f"3 B1 at {len(errs)} extreme cases (tools/score_extremes.py): bit-exact")
    err_ext = max(errs.values())
    report["fast_score"]["max_abs_err"] = max(err, err_odd, err_ext)

    comps = ex.build_merged_composites(pyrs, fe)
    # the main path's B2 work of one stereo frame: two launches of two jobs
    jobs = bwk.path_jobs({"bordered": comps.bordered, "sampling": comps.sampling})
    b2_err = 0.0
    for label, pair_jobs in jobs.items():
        got = wg.gather_windows_many(pair_jobs)
        want = [wg.gather_windows_plain(*job) for job in pair_jobs]
        torch.cuda.synchronize()
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        require(err == 0, f"B2 pair {label}: kernel != twin (max abs err {err})")
        b2_err = max(b2_err, err)
    frame_jobs = [job for pair_jobs in jobs.values() for job in pair_jobs]
    # the least traffic: the image bytes the frame's windows cover (the
    # bordered composite, read by both launches, once), the windows written
    # and the starts read
    b2_read, b2_lib = bwk.covered_bytes(frame_jobs), 0.0
    phase(f"3 B2 a stereo frame's windows cover {b2_read} distinct image bytes of "
          f"{sum(r.shape[0] * nr * nc for _, r, _, nr, nc in frame_jobs)} window bytes")
    b2_bytes = b2_read
    for img, r, c, nr, nc in frame_jobs:
        k = r.shape[0]
        hi, wi = img.shape
        kdev = device_ms(lambda: wg.gather_windows(img, r, c, nr, nc))
        pdev = device_ms(lambda: wg.gather_windows_plain(img, r, c, nr, nc))
        # the library call: one advanced-indexing gather, its indices made beforehand
        rows = r.long().clamp(0, hi - nr)[:, None] + torch.arange(nr, device=dev)
        cols = c.long().clamp(0, wi - nc)[:, None] + torch.arange(nc, device=dev)
        ri, ci = rows[:, :, None], cols[:, None, :]
        lib = device_ms(lambda: img[ri, ci])
        phase(f"3 B2 {nr}x{nc} K={k} alone on {hi}x{wi}: device time kernel {kdev:.4f} ms, "
              f"twin {pdev:.4f} ms, advanced indexing {lib:.4f} ms")
        b2_bytes += k * nr * nc + 8 * k
        b2_lib += lib

    def b2_frame():
        for pair_jobs in jobs.values():
            wg.gather_windows_many(pair_jobs)

    def b2_frame_plain():
        for pair_jobs in jobs.values():
            for job in pair_jobs:
                wg.gather_windows_plain(*job)

    ms, plain = cuda_ms(b2_frame), cuda_ms(b2_frame_plain)
    kdev, pdev = device_ms(b2_frame), device_ms(b2_frame_plain)
    phase(f"3 B2 a stereo frame's work (2 launches, {' and '.join(jobs)} pairs) on "
          f"{tuple(comps.bordered.shape)}: bit-exact, median per frame (events) kernel {ms:.4f} ms, "
          f"twin {plain:.4f} ms; device time kernel {kdev:.4f} ms, twin {pdev:.4f} ms")
    errs = bwk.b2_edge_errs(dev)
    bad = {k: e for k, e in errs.items() if e != 0}
    require(not bad, f"B2 kernel != twin at edge cases: {bad}")
    phase(f"3 B2 at {len(errs)} edge cases (tools/bench_window_kernels.py): bit-exact")
    errs["grid mix"] = bwk.b2_grid_mix_err(dev)
    require(errs["grid mix"] == 0, f"B2 kernel != twin at 48x23 + 1x24, K=2^20: {errs['grid mix']}")
    phase("3 B2 at 48x23 + 1x24 windows, K=2^20, in one launch (grids 2^20 blocks apart): bit-exact")
    floor = bwk.launch_floor_ms()
    phase(f"3 launch floor: one in-place add on one element, device time {floor:.4f} ms per call")
    # the report's times are device times (CUDA graph replays); B2's is the
    # two main-path launches of one frame together
    bound, bound_by = bound_ms(b2_bytes)
    report["gather_windows"] = dict(max_abs_err=max(b2_err, *errs.values()), ms=kdev,
                                    plain_ms=pdev, bound_ms=bound, bound_by=bound_by,
                                    library_ms=b2_lib)

    # phase 4 -------------------------------------------------------------
    sysm = System(camera, mbf, params, device="cuda")
    bench = Benchmark.the()
    bench.records.pop(FRONT_END_STREAM_TAG, None)
    port.reset_kernel_launches()
    est, gt, states, wall = [], [], [], []
    for k, (img_l, img_r, tcw_gt) in enumerate(frames):
        t0 = time.perf_counter()
        pose = sysm.track_stereo(img_l, img_r, timestamp=k / 20.0)
        wall.append((time.perf_counter() - t0) * 1e3)
        states.append(sysm.get_tracking_state())
        if pose is not None:
            est.append(pose)
            gt.append(tcw_gt)
    launches = port.kernel_launches()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trajectory_tum.txt")
        sysm.save_trajectory_tum(path)
        with open(path) as f:
            n_saved = len(f.read().strip().splitlines())
    sysm.shutdown()
    fe_ms = bench.records[FRONT_END_STREAM_TAG]
    ate = port.ate_rmse(est, gt)
    n_ok = sum(s.name == "OK" for s in states)
    phase(f"4 track_stereo {N_FRAMES} frames {W}x{H}: {n_ok}/{N_FRAMES} OK, "
          f"{len(est)} poses, {n_saved} saved, ATE RMSE {ate * 100:.4f} cm")
    phase(f"4 front-end ms/frame (stream window between CUDA events, host-bound): median "
          f"{statistics.median(fe_ms):.4f}, "
          f"after frame 0 median {statistics.median(fe_ms[1:]):.4f}, first {fe_ms[0]:.4f}")
    phase(f"4 track_stereo wall ms/frame: median {statistics.median(wall):.4f}, "
          f"after frame 0 median {statistics.median(wall[1:]):.4f}, first {wall[0]:.4f}")
    phase(f"4 kernel launches in the run: {launches}")
    require(n_ok == N_FRAMES, f"frames not tracked: {[s.name for s in states]}")
    require(len(est) == N_FRAMES and n_saved == N_FRAMES, "missing poses")
    require(ate < 0.01, f"ATE RMSE {ate} m >= 1 cm")
    require(launches == {"fast_score": N_FRAMES, "gather_windows": 2 * N_FRAMES,
                         "detect_fused": 0, "window_moments": 0, "sample_windows": 0,
                         "brief_descriptors": 0, **NO_T_LAUNCHES},
            f"expected 1 B1 + 2 B2 launches per frame, got {launches}")
    require("jax" not in sys.modules, "the port imported JAX")

    # phase 5 -------------------------------------------------------------
    on_card = sf.extract_and_match_stereo_packed(pair, params, mbf, FX).cpu().numpy()
    on_cpu = sf.extract_and_match_stereo_packed(pair.cpu(), params, mbf, FX).numpy()
    for col, name in ((0, "x"), (1, "y"), (2, "response"), (4, "octave"), (5, "valid")):
        require(np.array_equal(on_card[:, col], on_cpu[:, col]), f"front-end column {name} differs")
    d = np.abs(on_card[:, 3] - on_cpu[:, 3])
    ang = float(np.minimum(d, 360 - d).max())
    bits = np.unpackbits(
        on_card[:, 8:].astype(np.uint8) ^ on_cpu[:, 8:].astype(np.uint8), axis=1
    ).sum(axis=1)
    n_desc = int((bits > 0).sum())
    valid = on_cpu[:, 5] > 0.5
    agree = [
        float((np.abs(on_card[:, c] - on_cpu[:, c]) <= 1e-5 * np.abs(on_cpu[:, c]))[valid].mean())
        for c in (6, 7)
    ]
    phase(f"5 front-end card vs CPU: {int(valid.sum())} valid, ints equal, max angle diff "
          f"{ang:.3g} deg, {n_desc} descriptors differ (max {int(bits.max())} bits), "
          f"u_right/depth agree on {agree[0]:.4f}/{agree[1]:.4f} of valid slots")
    require(ang < 1e-3, "angles differ by >= 1e-3 deg")
    require(n_desc <= max(5, len(bits) // 100) and bits.max() <= 4, "descriptors beyond trig bound")
    require(min(agree) >= 0.99, "u_right/depth agree on < 99 % of valid slots")

    # phase 6: where the time goes (steady state, torch.profiler) ---------
    window, ops, n_ops = device_profile(lambda: fe(pair), reps=5)
    busy = sum(ops.values())
    top = sorted(ops.items(), key=lambda kv: -kv[1])
    if not ops:
        phase(NO_TRACE)
    phase(f"6 front-end device busy (profiler) {busy:.4f} ms/frame in a stream window of "
          f"{window:.4f} ms/frame ({100 * busy / window:.1f} % busy), "
          f"{n_ops:.0f} device ops/frame")
    for key, ms in top[:8]:
        phase(f"6   {ms:.4f} ms/frame  {key[:100]}")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as f:
        f.write(f"# {card}; front-end device ms per frame by op, 752x480 stereo\n")
        for key, ms in top:
            f.write(f"{ms:.6f}\t{key}\n")
    # whole track_stereo frames after initialisation, host tracking included
    sys2 = System(camera, mbf, params, device="cuda")
    sys2.track_stereo(frames[0][0], frames[0][1], timestamp=0.0)
    steps = iter(range(1, N_FRAMES))  # enough for the profiler's retries

    def track_next():
        k = next(steps)
        sys2.track_stereo(frames[k][0], frames[k][1], timestamp=k / 20.0)

    window, ops, _ = device_profile(track_next, reps=4)
    sys2.shutdown()
    if not ops:
        phase(NO_TRACE)
    # kernels and copies apart: the copy of the packed block to the host
    # may be timed while it waits behind the front-end
    copies = sum(t for key, t in ops.items() if key.startswith(("Memcpy", "Memset")))
    busy = sum(ops.values()) - copies
    phase(f"6 track_stereo kernels busy (profiler) {busy:.4f} ms/frame, copies "
          f"{copies:.4f} ms/frame, of {window:.4f} ms/frame between events "
          f"({100 * busy / window:.1f} % busy with kernels, 4 frames after the first two)")
    top = sorted(ops.items(), key=lambda kv: -kv[1])
    for key, ms in top[:4]:
        phase(f"6   {ms:.4f} ms/frame  {key[:100]}")
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "a") as f:
        f.write(f"# {card}; track_stereo device ms per frame by op, 4 frames after the "
                f"first two\n")
        for key, ms in top:
            f.write(f"{ms:.6f}\t{key}\n")

    # phase 7: the fused kernels against their twins -----------------------
    fused = port.FusedKernels(True, True, True)
    fe_mono = ex.feature_extractor(params, (H, W), port.FusedKernels(), "cuda")
    mono_pyr = pyramid.build_pyramid(pair[0], params, fe_mono.resize_taps())
    mono_comp, _, _ = fast.detection_composite(ex.detection_crops(mono_pyr, params)[1])
    b3 = []
    for label, img, m in (("mono", mono_comp, fe_mono.det_mask), ("stereo", comp, fe.det_mask)):
        b3.append(kernel_vs_twin(
            f"B3 {label} detection composite {tuple(img.shape)}",
            lambda: fast.detect_fused(img, m, params.ini_th_fast, params.min_th_fast),
            lambda: fast.detect_fused_plain(img, m, params.ini_th_fast, params.min_th_fast),
        ))
    # thresholds the path never uses: min_th <= 0 keeps zero and negative
    # scores in the int16 map, ini_th > 254 sends every tile to its retry
    errs = bsk.b3_extreme_errs(dev, {"mono composite": (mono_comp, fe_mono.det_mask)})
    bad = {k: e for k, e in errs.items() if e != 0}
    require(not bad, f"B3 kernel != twin at extreme thresholds: {bad}")
    phase(f"7 B3 at {len(errs)} extreme threshold cases (min_th <= 0, ini_th > 254): bit-exact")
    err_ext = max(errs.values())
    # the report's times are those of the mono composite, the path's shape
    n_px = mono_comp.numel()
    bound, bound_by = bound_ms(6 * n_px, B3_OPS_PER_PX * n_px, INT16X2_OPS_PER_S)
    report["detect_fused"] = dict(max_abs_err=max(err_ext, *(e for e, _, _ in b3)), ms=b3[0][1],
                                  plain_ms=b3[0][2], bound_ms=bound, bound_by=bound_by,
                                  library_ms=None)
    mono_comps = ex.build_merged_composites([mono_pyr], fe_mono)
    hm, wm = mono_comps.bordered.shape
    require((hm, wm) == (1762, 760), f"mono merged composite {hm}x{wm}")
    rng = np.random.default_rng(SEED)

    def starts(k, n):
        r = rng.integers(0, hm - n + 1, k).astype(np.int32)
        c = rng.integers(0, wm - n + 1, k).astype(np.int32)
        r[:4] = [-9, hm, 3 * hm, 0]  # out-of-bounds starts: clamped in-kernel
        c[:4] = [wm + 5, -1, 0, -10 * wm]
        return torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev)

    b4, b4_starts = {}, {}
    for k in (1000, 2000, 5000):
        r, c = b4_starts[k] = starts(k, 31)
        b4[k] = kernel_vs_twin(
            f"B4 31x31 moments K={k} on {hm}x{wm}",
            lambda: wg.window_moments(mono_comps.bordered, r, c, fe_mono.ic_weights, fused=True),
            lambda: wg.window_moments_plain(mono_comps.bordered, r, c, fe_mono.ic_weights),
        )
    errs = bwk.b4_edge_errs(dev)
    bad = {k: e for k, e in errs.items() if e != 0}
    require(not bad, f"B4 kernel != twin at edge cases: {bad}")
    phase(f"7 B4 at {len(errs)} edge cases (tools/bench_window_kernels.py): bit-exact")
    # the image bytes the K=1000 windows cover, their starts and the two
    # weight planes read, (K, 2) f32 written; a multiply and an add per
    # weight and pixel
    b4_read = bwk.covered_bytes([(mono_comps.bordered, *b4_starts[1000], 31, 31)])
    phase(f"7 B4 K=1000: the windows cover {b4_read} distinct image bytes of {1000 * 961}")
    bound, bound_by = bound_ms(b4_read + 1000 * (8 + 8) + 2 * 961 * 4, 1000 * 2 * 961 * 2)
    report["window_moments"] = dict(max_abs_err=max(*(v[0] for v in b4.values()), *errs.values()),
                                     ms=b4[1000][1], plain_ms=b4[1000][2], bound_ms=bound,
                                     bound_by=bound_by, library_ms=None)
    # B5's index mode, the TPU kernel's function, which no tracking path
    # runs since the rBRIEF mode: the kernels line reports the path's 0
    # launches, and this check pass's count apart as `check_launches`
    sampling = mono_comps.sampling
    b5_in = {}
    port.reset_kernel_launches()
    for k in (1000, 5000):
        r, c = starts(k, 37)
        ri = torch.from_numpy(rng.integers(0, 37, (k, 512)).astype(np.int32)).to(dev)
        ci = torch.from_numpy(rng.integers(0, 37, (k, 512)).astype(np.int32)).to(dev)
        b5_in[k] = (sampling, r, c, ri, ci, 37, 37)
        err = max_abs_err(wg.sample_windows(*b5_in[k], fused=True), wg.sample_windows_plain(*b5_in[k]))
        require(err == 0, f"B5 index mode K={k}: kernel != twin (max abs err {err})")
    errs = bwk.b5_edge_errs(dev)
    bad = {k: e for k, e in errs.items() if e != 0}
    require(not bad, f"B5 index mode != twin at edge cases: {bad}")
    index_launches = port.kernel_launches()["sample_windows"]
    phase(f"7 B5 index mode 37x37 x 512 at K=1000 / 5000 on {tuple(sampling.shape)} and at "
          f"{len(errs)} edge cases (tools/bench_window_kernels.py): bit-exact, "
          f"{index_launches} launches")
    b5 = {k: kernel_vs_twin(f"B5 index mode K={k}", lambda x=x: wg.sample_windows(*x, fused=True),
                            lambda x=x: wg.sample_windows_plain(*x))
          for k, x in b5_in.items()}
    _, r, c, ri, ci, _, _ = b5_in[1000]
    # the library call: one advanced-indexing pick
    hs, ws = sampling.shape
    rr = r.long().clamp(0, hs - 37)[:, None] + ri.long()
    cc = c.long().clamp(0, ws - 37)[:, None] + ci.long()
    b5_lib = device_ms(lambda: sampling[rr, cc])
    b5_read = bwk.picked_bytes(sampling, r, c, ri, ci, 37, 37)
    phase(f"7 B5 index mode K=1000: advanced indexing {b5_lib:.4f} ms; the picks read "
          f"{b5_read} distinct image bytes")
    # the image bytes the K=1000 picks read, both (K, 512) int32 index
    # planes and the starts read, (K, 512) u8 written
    bound, bound_by = bound_ms(b5_read + 1000 * (512 * 8 + 8 + 512))
    report["sample_windows"] = dict(max_abs_err=max(*(v[0] for v in b5.values()), *errs.values()),
                                     ms=b5[1000][1], plain_ms=b5[1000][2], bound_ms=bound,
                                     bound_by=bound_by, library_ms=b5_lib)
    # B5's rBRIEF mode: the whole fused brief_descriptors against its twin
    pattern = fe_mono.brief_pattern
    brief = {}
    for k in (1000, 5000):
        xy, ang, trig = bwk.brief_inputs(rng, hs, ws, k, dev)
        brief[k] = kernel_vs_twin(
            f"B5 rBRIEF mode K={k}, (cos, sin) pinned",
            lambda: tb.brief_descriptors(sampling, xy, ang, trig, pattern, fused=True),
            lambda: tb.brief_descriptors_plain(sampling, xy, ang, trig, pattern),
        )
        got = tb.brief_descriptors(sampling, xy, ang, None, pattern, fused=True)
        want = tb.brief_descriptors_plain(sampling, xy, ang, None, pattern)
        n_diff = int((got != want).any(1).sum())
        kdev = device_ms(lambda: tb.brief_descriptors(sampling, xy, ang, None, pattern, fused=True))
        pdev = device_ms(lambda: tb.brief_descriptors_plain(sampling, xy, ang, None, pattern))
        phase(f"7 B5 rBRIEF mode K={k}, trig in the kernel (cosf / sinf) against the twin's "
              f"torch.cos / torch.sin: {n_diff} of {k} descriptors differ; device time kernel "
              f"{kdev:.4f} ms, twin {pdev:.4f} ms")
        require(n_diff <= max(5, k // 100), f"B5 rBRIEF mode K={k}: {n_diff} descriptors differ")
        if k == 1000:
            brief_unpinned = (kdev, pdev, xy, ang)
    errs = bwk.brief_edge_errs(dev)
    bad = {k: e for k, e in errs.items() if e != 0}
    require(not bad, f"B5 rBRIEF mode != default composition at edge cases: {bad}")
    phase(f"7 B5 rBRIEF mode at {len(errs)} edge cases (tools/bench_window_kernels.py), "
          f"(cos, sin) pinned: bit-exact")
    # the report's times are the path's call: K=1000, trig in the kernel.
    # Bytes: the distinct image bytes its picks read, xy and the angle read
    # and 32 B written per keypoint, the pattern read once
    kdev, pdev, xy, ang = brief_unpinned
    ridx, cidx = tb.brief_indices(ang, None, pattern)
    brief_read = bwk.picked_bytes(sampling, *tb.brief_window_starts(xy), ridx, cidx, 37, 37)
    bound, bound_by = bound_ms(brief_read + 1000 * (8 + 4 + 32) + pattern.numel() * 4,
                               1000 * BRIEF_OPS_PER_KP, F32_NO_FMA_OPS_PER_S)
    phase(f"7 B5 rBRIEF mode K=1000: the picks read {brief_read} distinct image bytes; bound "
          f"{bound:.6f} ms ({bound_by})")
    report["brief_descriptors"] = dict(
        max_abs_err=max(*(v[0] for v in brief.values()), *errs.values()), ms=kdev, plain_ms=pdev,
        bound_ms=bound, bound_by=bound_by, library_ms=None)

    # phase 8: track_monocular under the fused configuration ---------------
    per_frame = {"fast_score": 0, "gather_windows": 0, "detect_fused": 1,
                 "window_moments": 1, "sample_windows": 0, "brief_descriptors": 1,
                 **NO_T_LAUNCHES}
    mono = System(camera, 0.0, params, sensor=System.MONOCULAR, sequential=True,
                  max_frames=8, device="cuda", fused=fused)
    mono_steps = [
        (lambda k=k, img=img_l: mono.track_monocular(img, timestamp=k / 20.0), tcw_gt)
        for k, (img_l, _, tcw_gt) in enumerate(frames) if k % 2 == 0
    ]
    res = run_entry_point("8 track_monocular", mono, mono_steps, MONO_STREAM_TAG, port, bench)
    mono_ate = port.ate_rmse(res["est"], res["gt"], with_scale=True)
    n = res["n"]
    phase(f"8 track_monocular {n} frames {W}x{H}: final state {res['states'][-1].name}, "
          f"{len(res['est'])} poses, Sim3 ATE RMSE {mono_ate * 100:.4f} cm")
    require(res["states"][-1].name == "OK", f"mono not tracking: {[s.name for s in res['states']]}")
    require(len(res["est"]) >= 6, "fewer than 6 mono poses")
    require(mono_ate < 0.05, f"mono Sim3 ATE {mono_ate} m >= 5 cm")
    require(res["launches"] == {k: v * n for k, v in per_frame.items()},
            f"expected 1 B3 + 1 B4 + 1 B5 rBRIEF and no B1/B2/B5 index launch per frame, "
            f"got {res['launches']}")
    fused_launches = dict(res["launches"])

    # phase 9: track_rgbd under the fused configuration --------------------
    rgbd_frames = port.rgbd_sequence(N_FRAMES, camera, H, W, seed=2, depth_noise=0.002)
    rgbd = System(camera, FX * 0.08, params, sensor=System.RGBD, sequential=True,
                  max_frames=8, device="cuda", fused=fused)
    rgbd_steps = [
        (lambda k=k, img=img, d=depth: rgbd.track_rgbd(img, d, timestamp=k / 20.0), tcw_gt)
        for k, (img, depth, tcw_gt) in enumerate(rgbd_frames)
    ]
    res = run_entry_point("9 track_rgbd", rgbd, rgbd_steps, RGBD_STREAM_TAG, port, bench)
    rgbd_ate = port.ate_rmse(res["est"], res["gt"])
    n_ok = sum(s.name == "OK" for s in res["states"])
    phase(f"9 track_rgbd {N_FRAMES} frames {W}x{H}: {n_ok}/{N_FRAMES} OK, "
          f"{len(res['est'])} poses, ATE RMSE {rgbd_ate * 100:.4f} cm")
    require(n_ok == N_FRAMES and len(res["est"]) == N_FRAMES, "RGB-D frames not tracked")
    require(rgbd_ate < 0.01, f"RGB-D ATE RMSE {rgbd_ate} m >= 1 cm")
    require(res["launches"] == {k: v * N_FRAMES for k, v in per_frame.items()},
            f"expected 1 B3 + 1 B4 + 1 B5 rBRIEF and no B1/B2/B5 index launch per frame, "
            f"got {res['launches']}")
    for k, v in res["launches"].items():
        fused_launches[k] += v
    require("jax" not in sys.modules, "the port imported JAX")

    # phase 10: fused against default, one frame --------------------------
    fe_fused = sf.front_end(params, (H, W), mbf, FX, "cuda", fused)
    fe_mono_fused = ex.feature_extractor(params, (H, W), fused, "cuda")

    def mono_packed(extractor):
        return ex.pack_features(extractor(pair[0]))

    for label, a, b in (
        ("stereo front-end", fe(pair), fe_fused(pair)),
        ("mono extractor", mono_packed(fe_mono), mono_packed(fe_mono_fused)),
    ):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        cols = [c for c in range(a.shape[1]) if not np.array_equal(a[:, c], b[:, c])]
        phase(f"10 {label} fused vs default: {a.shape[0]} slots, {int((a[:, 5] > 0.5).sum())} "
              f"valid, columns that differ: {cols}")
        require(a.shape == b.shape and not cols, f"{label}: fused != default in columns {cols}")

    # phase 11: device time of the front-ends, default and fused -----------
    for label, fns in (
        ("stereo front-end", (lambda: fe(pair), lambda: fe_fused(pair))),
        ("mono extractor", (lambda: fe_mono(pair[0]), lambda: fe_mono_fused(pair[0]))),
    ):
        for cfg, fn in zip(("default", "fused"), fns):
            window, ops, n_ops = device_profile(fn, reps=5)
            busy = sum(ops.values())
            if not ops:
                phase(NO_TRACE)
            phase(f"11 {label} {cfg}: device busy (profiler) {busy:.4f} ms/frame in a stream "
                  f"window of {window:.4f} ms/frame ({100 * busy / window:.1f} % busy), "
                  f"{n_ops:.0f} device ops/frame")
    require("jax" not in sys.modules, "the port imported JAX")

    # phase 12: the A/B harness of the FAST-score variants T1-T4 -----------
    from orbslam3_tpu_torch.ops import fast_variants as fv
    from orbslam3_tpu_torch.tools import bench_fast_variants as bfv

    images = {"harness": torch.from_numpy(bfv.harness_image()).to(dev), "stereo composite": comp}
    port.reset_kernel_launches()
    results = bfv.check(images, log=lambda line: phase("12 " + line))
    t_launches = {k: v for k, v in port.kernel_launches().items() if k.startswith("fast_variant")}
    phase(f"12 harness check pass: {len(results)} cases, kernel launches in it: {t_launches}")
    require(all(r["max_abs_err"] == 0 for r in results), "a T1-T4 case differs from its plain version")
    require(all(v > 0 for v in t_launches.values()), f"a T1-T4 kernel never launched: {t_launches}")
    odd_results = bfv.check({"odd": odd}, log=lambda line: phase("12 " + line))
    require(all(r["max_abs_err"] == 0 for r in odd_results),
            "a T1-T4 case differs from its plain version on the odd 97x211 image")
    big = sorted({f"{r['function']} {r['case']} ({fv.halo_bytes(v.rows, v.cols)} B)"
                  for r in results + odd_results
                  for v in [bfv.FUNCTIONS[r["function"]][2](*r["args"])]
                  if fv.halo_bytes(v.rows, v.cols) > 48 * 1024})
    phase(f"12 cases whose halo needs more than 48 KB of shared memory, bit-exact on all three "
          f"images: {'; '.join(big)}")
    require(len(big) >= 3, f"expected the T3/T4 tiles above 48 KB among the cases, got {big}")
    bfv.time_cases(images, results, log=lambda line: phase("12 " + line))
    defaults = {  # each TPU function's default case
        "t1": (False, None, None), "t2": (32,), "t3": (48, 384, "twopass"),
        "t4": (48, 384, fv.VANHERK),
    }
    for fn, args in defaults.items():
        wrapper, plain, _ = bfv.FUNCTIONS[fn]
        for image_name, img in images.items():
            got, want = wrapper(img, *args), plain(img, *args)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            require(err == 0, f"{fn} {image_name}: kernel != plain (max abs err {err})")
            kdev, pdev = device_ms(lambda: wrapper(img, *args)), device_ms(lambda: plain(img, *args))
            bound, bound_by = bfv.score_bound_ms(img.shape)
            phase(f"12 {fn} default {args} on {image_name} {tuple(img.shape)}: bit-exact, "
                  f"device time kernel {kdev:.4f} ms, plain {pdev:.4f} ms, "
                  f"bound {bound:.4f} ms ({bound_by}), launches {t_launches[f'fast_variant_{fn}']}")
            if image_name == "harness":  # the report's shape: the harness's own image
                report[f"fast_variant_{fn}"] = dict(
                    max_abs_err=err, ms=kdev, plain_ms=pdev, bound_ms=bound, bound_by=bound_by,
                    library_ms=None,
                )

    # phase 13: the dense matcher on the card against the CPU --------------
    from orbslam3_tpu_torch.ops import matching

    args = matcher_inputs(MATCH_M, MATCH_K)
    t0 = time.perf_counter()
    on_cpu = matching.search_by_projection_batch(*map(torch.from_numpy, args))
    cpu_ms = (time.perf_counter() - t0) * 1e3
    card_args = [torch.from_numpy(a).to(dev) for a in args]
    on_card = matching.search_by_projection_batch(*card_args)
    for name, a, b in zip(("best index", "best distance", "matched"), on_card, on_cpu):
        require(a.dtype == b.dtype and torch.equal(a.cpu(), b), f"dense matcher: {name} differs")
    require(int(on_cpu[2].sum()) > 0, "dense matcher: no map point matched")
    card_ms = device_ms(lambda: matching.search_by_projection_batch(*card_args))
    phase(f"13 search_by_projection_batch {MATCH_M} x {MATCH_K}: card == CPU (ints equal, "
          f"{int(on_cpu[2].sum())} matched); device time {card_ms:.4f} ms, CPU wall "
          f"{cpu_ms:.4f} ms")

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "orbslam3_tpu"))
    phase(f"modules of JAX or the JAX package loaded: {leaked or 'none'}")
    require(not leaked, f"the port imported {leaked}")

    kernels = [
        dict(name="fast_score", route="cuda", source="orbslam3_tpu_torch/csrc/fast_score.cu",
             replaces="orbslam3_tpu/ops/fast.py:101", launches=launches["fast_score"],
             **report["fast_score"]),
        dict(name="gather_windows", route="cuda",
             source="orbslam3_tpu_torch/csrc/gather_windows.cu",
             replaces="orbslam3_tpu/ops/window_gather.py:70",
             launches=launches["gather_windows"], **report["gather_windows"]),
        dict(name="detect_fused", route="cuda",
             source="orbslam3_tpu_torch/csrc/detect_fused.cu",
             replaces="orbslam3_tpu/ops/fast.py:274",
             launches=fused_launches["detect_fused"], **report["detect_fused"]),
        dict(name="window_moments", route="cuda",
             source="orbslam3_tpu_torch/csrc/window_moments.cu",
             replaces="orbslam3_tpu/ops/window_gather.py:152",
             launches=fused_launches["window_moments"], **report["window_moments"]),
        dict(name="sample_windows", route="cuda",
             source="orbslam3_tpu_torch/csrc/sample_windows.cu",
             replaces="orbslam3_tpu/ops/window_gather.py:256",
             launches=fused_launches["sample_windows"], check_launches=index_launches,
             **report["sample_windows"]),
        dict(name="brief_descriptors", route="cuda",
             source="orbslam3_tpu_torch/csrc/sample_windows.cu",
             replaces="orbslam3_tpu/ops/window_gather.py:256",
             launches=fused_launches["brief_descriptors"], **report["brief_descriptors"]),
    ] + [
        dict(name=f"fast_variant_{fn}", route="cuda",
             source="orbslam3_tpu_torch/csrc/fast_variants.cu", replaces=replaces,
             launches=t_launches[f"fast_variant_{fn}"], **report[f"fast_variant_{fn}"])
        for fn, replaces in (
            ("t1", "tools/bench_fast_variants.py:49"), ("t2", "tools/bench_fast_variants2.py:100"),
            ("t3", "tools/bench_fast_variants3.py:63"), ("t4", "tools/bench_fast_variants4.py:71"),
        )
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
