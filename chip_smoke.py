"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:
  1. require CUDA and print the card (name, power limit);
  2. build the hand-written kernels from orbslam3_tpu_torch/csrc;
  3. each kernel against its plain PyTorch twin on the card, bit-exact, at
     the shapes of the main path (752x480 stereo, 8 levels, 1000 features),
     with both times from CUDA events;
  4. the stereo tracking path through its entry points: System.track_stereo
     over a 30-frame synthetic sequence, save_trajectory_tum, shutdown —
     every frame tracked, ATE RMSE under 1 cm, one B1 and four B2 launches
     per frame, and no JAX in the process;
  5. the whole front-end on the card against the same code on the CPU;
  6. torch.profiler: the front-end's device-busy time per frame by device
     op (full table in chiprun_out/chip_smoke_profile.txt), and the
     device-busy share of whole track_stereo frames;
  7. the fused kernels B3, B4 and B5 against their plain twins on the card,
     bit-exact, at the shapes of the mono / RGB-D path (detection
     composites of one and two cameras, 1000 / 2000 / 5000 orientation
     windows, 1000 / 5000 BRIEF samplings), with device times;
  8. System.track_monocular over every second frame of the sequence under
     FusedKernels(True, True, True) (the 5x init extractor takes 5000
     features): tracking OK, >= 6 poses, Sim3 ATE under 5 cm, one B3, B4
     and B5 launch per frame and no B1 or B2 launch;
  9. System.track_rgbd over a 30-frame synthetic RGB-D sequence under the
     same configuration: every frame tracked, ATE under 1 cm, the same
     launch counts;
 10. fused against default on one frame: the stereo front-end's and the
     mono extractor's packed outputs equal column for column;
 11. torch.profiler: the stereo and mono front-ends' device-busy time and
     device ops per frame, default and fused side by side.

The line before last is the JSON kernel report (launches: phase 4's for
B1 and B2, phases 8 and 9's for B3, B4 and B5), the last line the JSON
result.  Imports nothing of JAX.
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

H, W = 480, 752
FX = 435.2
BASELINE = 0.11
N_FRAMES = 30
SEED = 1
REPS = 30


def phase(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median device time of fn() in ms (CUDA events, after warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


PROFILE_TRIES = 6
NO_TRACE = ("the profiler's traces held no device event: the busy time below is not "
            "measured")


def device_profile(fn, reps: int = 10):
    """(event ms per call, {op: device ms per call}, device ops launched
    per call) of fn() under torch.profiler: kernels, memcpys, memsets.

    Now and then the profiler's trace comes back holding no device event at
    all (on an H100 about 3 sessions in 1000, often two or three in a row);
    every fn profiled here launches device work, so such a session is run
    again, up to PROFILE_TRIES times.  If every one came back empty, the
    dict is empty and the caller says the time was not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
        # device-side events only (kernels, memcpy, memset): the CPU ops that
        # launched them carry the same time again, and a record_function range
        # shows on the device too, under its CPU name, spanning its kernels
        avgs = prof.key_averages()
        cpu_keys = {a.key for a in avgs if a.device_type == DeviceType.CPU}
        dev = [
            a for a in avgs
            if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0
            and a.key not in cpu_keys
        ]
        if dev:
            break
    ops = {a.key: a.self_device_time_total / 1e3 / reps for a in dev}
    return start.elapsed_time(end) / reps, ops, sum(a.count for a in dev) / reps


def device_ms(fn, kernel: str | tuple | None = None) -> tuple[float, str]:
    """(ms, how) per call of fn(): the device time of the kernel(s) named
    `kernel`, or of all its device ops when `kernel` is None, from
    torch.profiler ("profiler"); where the profiler's traces held none of
    them, the median window between CUDA events around fn() ("events")."""
    _, ops, _ = device_profile(fn)
    names = None if kernel is None else (kernel,) if isinstance(kernel, str) else kernel
    ms = sum(t for key, t in ops.items() if names is None or any(n in key for n in names))
    if ms > 0:
        return ms, "profiler"
    return cuda_ms(fn), "events"


def kernel_vs_twin(label: str, kernel_fn, twin_fn, names) -> tuple[float, float, float]:
    """(max abs err, kernel device ms, twin device ms) of a wrapper call
    against its plain twin on the same card tensors; fails unless equal."""
    got, want = kernel_fn(), twin_fn()
    torch.cuda.synchronize()
    if isinstance(got, tuple):
        got, want = torch.stack(got), torch.stack(want)
    err = max_abs_err(got, want)
    require(err == 0, f"{label}: kernel != twin (max abs err {err})")
    kdev, khow = device_ms(kernel_fn, names)
    pdev, phow = device_ms(twin_fn)
    phase(f"7 {label}: bit-exact, device time kernel {kdev:.4f} ms ({khow}), twin "
          f"{pdev:.4f} ms ({phow})")
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
    from orbslam3_tpu_torch.ops import fast, pyramid, window_gather as wg
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
        kdev, khow = device_ms(lambda: fast.raw_score_map(img, m), "fast_score_kernel")
        pdev, phow = device_ms(lambda: fast.raw_score_map_plain(img, m))
        phase(f"3 B1 {name} {tuple(img.shape)}: bit-exact, median per call (events) kernel "
              f"{ms:.4f} ms, twin {plain:.4f} ms; device time kernel {kdev:.4f} ms ({khow}), "
              f"twin {pdev:.4f} ms ({phow})")
        return err, kdev, pdev

    err, ms, plain = b1_case("detection composite", comp, fe.det_mask)
    report["fast_score"] = dict(max_abs_err=err, ms=ms, plain_ms=plain)
    odd = torch.randint(0, 256, (97, 211), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(SEED)).to(dev)
    err_odd, _, _ = b1_case("odd size, frame test", odd, None)
    report["fast_score"]["max_abs_err"] = max(err, err_odd)

    comps = ex.build_merged_composites(pyrs, fe)
    img2d = comps.bordered
    hc, wc = img2d.shape
    rng = np.random.default_rng(SEED)
    b2_err, b2_ms, b2_plain = 0.0, 0.0, 0.0
    for nr, nc, k in ((31, 31, 2000), (37, 37, 2000), (11, 11, 1000), (11, 21, 1000)):
        r = rng.integers(0, hc - nr + 1, k).astype(np.int32)
        c = rng.integers(0, wc - nc + 1, k).astype(np.int32)
        r[:4] = [-9, hc, 3 * hc, 0]  # out-of-bounds starts: clamped in-kernel
        c[:4] = [wc + 5, -1, 0, -10 * wc]
        r, c = torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev)
        got = wg.gather_windows(img2d, r, c, nr, nc)
        want = wg.gather_windows_plain(img2d, r, c, nr, nc)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"B2 {nr}x{nc} K={k}: kernel != twin (max abs err {err})")
        ms = cuda_ms(lambda: wg.gather_windows(img2d, r, c, nr, nc))
        plain = cuda_ms(lambda: wg.gather_windows_plain(img2d, r, c, nr, nc))
        kdev, khow = device_ms(
            lambda: wg.gather_windows(img2d, r, c, nr, nc), "gather_windows_kernel"
        )
        pdev, phow = device_ms(lambda: wg.gather_windows_plain(img2d, r, c, nr, nc))
        phase(f"3 B2 {nr}x{nc} K={k} on {hc}x{wc}: bit-exact, median per call (events) "
              f"kernel {ms:.4f} ms, twin {plain:.4f} ms; device time kernel {kdev:.4f} ms "
              f"({khow}), twin {pdev:.4f} ms ({phow})")
        b2_err, b2_ms, b2_plain = max(b2_err, err), b2_ms + kdev, b2_plain + pdev
    # the report's times are device times (profiler); B2's is the four
    # main-path launches of one frame together
    report["gather_windows"] = dict(max_abs_err=b2_err, ms=b2_ms, plain_ms=b2_plain)

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
    require(launches == {"fast_score": N_FRAMES, "gather_windows": 4 * N_FRAMES,
                         "detect_fused": 0, "window_moments": 0, "sample_windows": 0},
            f"expected 1 B1 + 4 B2 launches per frame, got {launches}")
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
            ("detect_select_kernel", "nms3_kernel"),
        ))
    # the report's times are those of the mono composite, the path's shape
    report["detect_fused"] = dict(max_abs_err=max(e for e, _, _ in b3), ms=b3[0][1],
                                  plain_ms=b3[0][2])
    mono_comps = ex.build_merged_composites([mono_pyr], fe_mono)
    hm, wm = mono_comps.bordered.shape
    require((hm, wm) == (1762, 760), f"mono merged composite {hm}x{wm}")

    def starts(k, n):
        r = rng.integers(0, hm - n + 1, k).astype(np.int32)
        c = rng.integers(0, wm - n + 1, k).astype(np.int32)
        r[:4] = [-9, hm, 3 * hm, 0]  # out-of-bounds starts: clamped in-kernel
        c[:4] = [wm + 5, -1, 0, -10 * wm]
        return torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev)

    b4 = {}
    for k in (1000, 2000, 5000):
        r, c = starts(k, 31)
        b4[k] = kernel_vs_twin(
            f"B4 31x31 moments K={k} on {hm}x{wm}",
            lambda: wg.window_moments(mono_comps.bordered, r, c, fe_mono.ic_weights, fused=True),
            lambda: wg.window_moments_plain(mono_comps.bordered, r, c, fe_mono.ic_weights),
            "window_moments_kernel",
        )
    report["window_moments"] = dict(max_abs_err=max(v[0] for v in b4.values()),
                                     ms=b4[1000][1], plain_ms=b4[1000][2])
    b5 = {}
    for k in (1000, 5000):
        r, c = starts(k, 37)
        ri = torch.from_numpy(rng.integers(0, 37, (k, 512)).astype(np.int32)).to(dev)
        ci = torch.from_numpy(rng.integers(0, 37, (k, 512)).astype(np.int32)).to(dev)
        b5[k] = kernel_vs_twin(
            f"B5 37x37 x 512 samples K={k} on {hm}x{wm}",
            lambda: wg.sample_windows(mono_comps.sampling, r, c, ri, ci, 37, 37, fused=True),
            lambda: wg.sample_windows_plain(mono_comps.sampling, r, c, ri, ci, 37, 37),
            "sample_windows_kernel",
        )
    report["sample_windows"] = dict(max_abs_err=max(v[0] for v in b5.values()),
                                     ms=b5[1000][1], plain_ms=b5[1000][2])

    # phase 8: track_monocular under the fused configuration ---------------
    per_frame = {"fast_score": 0, "gather_windows": 0, "detect_fused": 1,
                 "window_moments": 1, "sample_windows": 1}
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
            f"expected 1 B3 + 1 B4 + 1 B5 and no B1/B2 launch per frame, got {res['launches']}")
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
            f"expected 1 B3 + 1 B4 + 1 B5 and no B1/B2 launch per frame, got {res['launches']}")
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
             launches=fused_launches["sample_windows"], **report["sample_windows"]),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
