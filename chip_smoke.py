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
     device-busy share of whole track_stereo frames.

The line before last is the JSON kernel report, the last line the JSON
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


def device_profile(fn, reps: int = 10):
    """(event ms per call, {op: device ms per call}, device ops launched
    per call) of fn() under torch.profiler: kernels, memcpys, memsets."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
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
    ops = {a.key: a.self_device_time_total / 1e3 / reps for a in dev}
    return start.elapsed_time(end) / reps, ops, sum(a.count for a in dev) / reps


def kernel_device_ms(fn, kernel: str) -> float:
    """Device time per launch of the kernel named `kernel` (profiler)."""
    _, ops, _ = device_profile(fn)
    ms = sum(t for key, t in ops.items() if kernel in key)
    require(ms > 0, f"the profiler saw no device time for {kernel}")
    return ms


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
    from orbslam3_tpu_torch.slam.system import FRONT_END_STREAM_TAG, System
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
        kdev = kernel_device_ms(lambda: fast.raw_score_map(img, m), "fast_score_kernel")
        _, plain_ops, _ = device_profile(lambda: fast.raw_score_map_plain(img, m))
        pdev = sum(plain_ops.values())
        phase(f"3 B1 {name} {tuple(img.shape)}: bit-exact, median per call (events) kernel "
              f"{ms:.4f} ms, twin {plain:.4f} ms; device time (profiler) kernel {kdev:.4f} ms, "
              f"twin {pdev:.4f} ms")
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
        kdev = kernel_device_ms(
            lambda: wg.gather_windows(img2d, r, c, nr, nc), "gather_windows_kernel"
        )
        _, plain_ops, _ = device_profile(lambda: wg.gather_windows_plain(img2d, r, c, nr, nc))
        pdev = sum(plain_ops.values())
        phase(f"3 B2 {nr}x{nc} K={k} on {hc}x{wc}: bit-exact, median per call (events) "
              f"kernel {ms:.4f} ms, twin {plain:.4f} ms; device time (profiler) kernel "
              f"{kdev:.4f} ms, twin {pdev:.4f} ms")
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
    require(launches == {"fast_score": N_FRAMES, "gather_windows": 4 * N_FRAMES},
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
    steps = iter(range(1, 6))

    def track_next():
        k = next(steps)
        sys2.track_stereo(frames[k][0], frames[k][1], timestamp=k / 20.0)

    window, ops, _ = device_profile(track_next, reps=4)
    sys2.shutdown()
    # kernels and copies apart: the copy of the packed block to the host
    # may be timed while it waits behind the front-end
    copies = sum(t for key, t in ops.items() if key.startswith(("Memcpy", "Memset")))
    busy = sum(ops.values()) - copies
    phase(f"6 track_stereo kernels busy (profiler) {busy:.4f} ms/frame, copies "
          f"{copies:.4f} ms/frame, of {window:.4f} ms/frame between events "
          f"({100 * busy / window:.1f} % busy with kernels, frames 2-5)")
    top = sorted(ops.items(), key=lambda kv: -kv[1])
    for key, ms in top[:4]:
        phase(f"6   {ms:.4f} ms/frame  {key[:100]}")
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "a") as f:
        f.write(f"# {card}; track_stereo device ms per frame by op, frames 2-5\n")
        for key, ms in top:
            f.write(f"{ms:.6f}\t{key}\n")

    kernels = [
        dict(name="fast_score", route="cuda", source="orbslam3_tpu_torch/csrc/fast_score.cu",
             replaces="orbslam3_tpu/ops/fast.py:101", launches=launches["fast_score"],
             **report["fast_score"]),
        dict(name="gather_windows", route="cuda",
             source="orbslam3_tpu_torch/csrc/gather_windows.cu",
             replaces="orbslam3_tpu/ops/window_gather.py:70",
             launches=launches["gather_windows"], **report["gather_windows"]),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
