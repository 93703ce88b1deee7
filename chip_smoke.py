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
     in-place add on one element in the same CUDA-graph harness; then K1
     (the selection's candidate pools), K2 (the stereo Hamming match) and
     K3 (the SAD refinement and median filter), bit for bit against their
     twins on the main path's inputs (a stereo frame's 16 score maps and
     the mono initialisation's 5000-feature call for K1, the frame's
     features, pair block and strips for K2 and K3) and at the edge cases
     of orbslam3_tpu_torch/tools/bench_match_kernels.py (K = 1, K not a
     multiple of a block, K = 2000, every slot invalid, rows with no valid
     pair, distance and slide ties, n_ok = 0 and one ok slot, odd cells,
     views, 32 and 40 maps), each timed (device time, bound, share, twin);
  4. the stereo tracking path through its entry points: System.track_stereo
     over a 30-frame synthetic sequence, save_trajectory_tum, shutdown —
     every frame tracked, ATE RMSE under 1 cm, one B1, two B2, two K1, one
     K2 and two K3 launches per frame, and no JAX in the process (each
     frame's front-end is one replay of its CUDA graph, captured at frame
     0; the launches are counted under replay, as in every later phase);
  5. the whole front-end on the card against the same code on the CPU;
  6. torch.profiler: the front-end's device-busy time per frame by device
     op, eager (op by op) and graphed side by side (full tables in
     chiprun_out/chip_smoke_profile.txt), and the device-busy share of
     whole track_stereo frames;
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
     B4, one B5 rBRIEF and two K1 launches per frame, and no other;
  9. System.track_rgbd over a 30-frame synthetic RGB-D sequence under the
     same configuration: every frame tracked, ATE under 1 cm, the same
     launch counts;
 10. fused against default on one frame: the stereo front-end's and the
     mono extractor's packed outputs equal column for column;
 11. torch.profiler: the stereo and mono front-ends' device-busy time and
     device ops per frame, default and fused, eager and graphed, side by
     side;
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
     keypoints, on the card against the CPU: integers equal, card time;
 14. the stereo fisheye path at the TUM-VI configuration: System.from_files
     on TUM-VI's stereo-inertial settings (two KannalaBrandt8 cameras,
     512x512, lapping areas over the whole image, 1000 features, the IMU;
     orbslam3_tpu_torch/tools/tumvi_scene.py), track_stereo with the IMU
     over 40 rendered frames: every frame tracked, visual-inertial
     initialisation done, ATE RMSE under 1.2 cm (printed beside the JAX
     package's on the same frames), map points observed by both cameras,
     one B1, one B2 and two K1 launches per frame (the fisheye path runs
     no rectified left-right matcher: no K2, no K3); extract_fisheye_pair
     on the card
     against the CPU (integers equal, angles and descriptors within the
     trig bound) and under FusedKernels(True, True, True) equal to the
     default;
 15. batched prefetch: prefetch_stereo_batch over phase 4's sequence in
     windows of 8 frames (the last one 6), each handle consumed in order by
     track_stereo_prefetched: phase 4's poses bit for bit and its map
     statistics, phase 4's launches per frame; its stream window per
     frame beside the per-frame front-end's, measured just before and after;
 16. the stereo front-end on a geometry that is not flat (120x160, 1000
     features: each camera through the per-level extractor): the card
     against the CPU (integers equal, angles, descriptors, u_right and
     depth as phase 5), one B1, three B2, four K1 (a selection per camera),
     one K2 and two K3 launches;
 17. the EuRoC driver (orbslam3_tpu_torch.examples.run_euroc) on a EuRoC
     ASL tree written here with utils.imageio: 30 frames of a distorted
     752x480 rig at MH01's calibration and imu0; stereo, stereo-inertial
     and --batch 8, each with every frame in its trajectory file, ATE under
     2 cm through tools.evaluate_ate, phase 4's launches a frame;
     PNG decode, device remap, tracking and the driver's wall ms per frame
     printed, the remap on the card equal to the CPU's; the rectifier's
     remap as a CUDA graph (captured at a fresh rectifier's first frame,
     replayed for the other 29) equal to the eager remap bit for bit on
     every frame, its time a pair graphed and eager (CUDA events);
 18. the TUM-RGBD driver under --fused detect,moments,sample on phase 9's
     sequence as a TUM tree (colour read as grey, 16-bit depth): every
     frame, ATE under 2 cm, one B3, one B4, one B5 rBRIEF and two K1
     launches a frame;
 19. the entry hook's step on the card against the CPU (integers equal),
     and the bench's measurement at 16 frames, its headline printed (the
     graphed front-end) beside the eager stream window;
 20. the frame graphs (utils/frame_graph.py): each program the System
     replays against its eager program, bit for bit with the same launches
     a frame, on three inputs or more (stereo default and fused, non-flat
     stereo, phase 14's fisheye pair block, mono's two extractors, the
     RGB-D extractor on RGB-D images, the default mono extractor), each
     graph's capture time and pool size; every row of a batch equal to a
     single frame; the stream window per frame eager and graphed over
     phase 4's frames (two turns each) and a batch's per frame; the
     30-frame track_stereo wall eager and graphed (two turns each, phase
     4's poses bit for bit in every run); prefetch_stereo on the side
     stream interleaved with track_stereo on the current one (every
     prefetched block equal to eager, phase 4's poses); and a program with
     an .item() inside whose capture raises at each call, with nothing run
     in its place;
 21. the tools that measure the whole System (orbslam3_tpu_torch/tools):
     bench_system at 60 frames (the threaded System with the prefetch
     pipeline: every frame tracked, ATE under 1 cm, phase 4's launches a
     frame), every stage of bench_stages (device ms per call,
     CUDA graph of 20 calls), bench_matchers at every size (500 to 100000
     candidates; at each the device matcher returns the host matcher's
     matches), and trace_ops on one frame: its graphed frame's node count,
     busy time and largest gap, and its top 10 kernels (the whole report
     in chiprun_out/chip_smoke_trace_ops.txt).
     Each result on its own line beside the card's name and power limit;
 22. in a process that refuses cv2, PIL and matplotlib (and JAX): System.from_files(
     use_viewer=True) on phase 17's rig tracks 4 stereo frames and its
     viewer writes frame and map PNGs that utils.imageio decodes, and
     make_texture(2048) draws its polygons with utils/raster.fill_poly; where
     cv2 is importable in the smoke's own process, that texture equals the
     one drawn with cv2.fillPoly bit for bit, both timed, and the line
     after prints cv2's version and whether its putText of the printable
     characters equals utils/raster.put_text's (the glyph table is cv2
     5.x's anti-aliased text, cv2 4.x draws it without: printed, not
     required).
Phase 1 also prints whether cv2 is importable (the port needs none).

Phase 2 also requires the port's native host library to build
(`native.available()`).  Last, no module of JAX or of the JAX package may
be loaded.  The line before last is the JSON kernel report (launches:
phase 4's for B1, B2, K1, K2 and K3, phases 8 and 9's for B3, B4 and B5's rBRIEF mode,
phase 7's check pass for B5's index mode and phase 12's for T1-T4, which
no tracking path runs; bounds computed from this run's shapes and, for the
window kernels B2, B4 and B5, from the distinct image bytes this run's
windows cover or its picks read, for K2 from the pairs this run's frame
passes), the last line the JSON result.  Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

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
    window_ms,
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
# phase 14: frames of the TUM-VI sequence, and the JAX package's ATE on the
# same frames on the CPU (tests/test_torch_fisheye.py::
# test_tumvi_configuration_matches_reference, slow tier)
N_FISHEYE = 40
REF_TUMVI_ATE_CM = 0.2945
# phase 15: frames per batched prefetch; phase 16: a geometry that is not flat
BATCH = 8
NON_FLAT_HW = (120, 160)
# the dense matcher's inputs: map points x frame keypoints
MATCH_M, MATCH_K = 30000, 1000
# phase 17: a EuRoC rig at MH01's calibration (cam0 / cam1 intrinsics and
# radtan distortion), its right camera rotated a few mrad, 0.11 m apart
EUROC_CAMS = (
    ([458.654, 457.296, 367.215, 248.375], [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]),
    ([457.587, 456.134, 379.999, 255.238], [-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05]),
)
EUROC_T0_NS = 1403636579 * 10**9
EUROC_BATCH = 8
# phase 19: the bench's frames at the smoke's reduced count
BENCH_FRAMES = 16
TOOL_FRAMES = 60  # bench_system's frames in phase 21
# kernel launches a frame: a rectified stereo frame (B1, two B2, K1's two,
# K2, K3's two), the fused mono / RGB-D paths (B3, B4, B5 rBRIEF and K1's
# two), the fisheye path (no left-right matcher) and a stereo frame on a
# geometry that is not flat (one selection per camera, three B2)
STEREO_PER_FRAME = {"fast_score": 1, "gather_windows": 2, "grid_pool": 2, "stereo_hamming": 1,
                    "sad_refine": 2}
FUSED_PER_FRAME = {"detect_fused": 1, "window_moments": 1, "brief_descriptors": 1,
                   "grid_pool": 2}
FISHEYE_PER_FRAME = {"fast_score": 1, "gather_windows": 1, "grid_pool": 2}
NON_FLAT_PER_FRAME = dict(STEREO_PER_FRAME, gather_windows=3, grid_pool=4)
# the System's own stage records a driver run prints (host wall, or the
# stream window between CUDA events for `.stream`)
STAGE_TAGS = (
    "1.0_GrabImageStereo.preprocess", "1.1_GrabImageStereo.extract",
    "1.1_GrabImageStereo.extract.stream", "1.1_GrabImageRGBD.extract.stream", "2_Track",
)
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


def compare_card_cpu(label: str, on_card: np.ndarray, on_cpu: np.ndarray, n: int) -> str:
    """Equal integer columns (x, y, response, octave, valid) of two packed
    (n, 40) blocks, angles within 1e-3 degrees and descriptors within the
    trig bound (at most 1 % differ, by at most 4 bits); returns a summary."""
    for col, name in ((0, "x"), (1, "y"), (2, "response"), (4, "octave"), (5, "valid")):
        require(np.array_equal(on_card[:, col], on_cpu[:, col]), f"{label}: column {name} differs")
    d = np.abs(on_card[:, 3] - on_cpu[:, 3])
    ang = float(np.minimum(d, 360 - d).max()) if len(d) else 0.0
    bits = np.unpackbits(
        on_card[:, 8:].astype(np.uint8) ^ on_cpu[:, 8:].astype(np.uint8), axis=1
    ).sum(axis=1)
    n_desc = int((bits > 0).sum())
    require(ang < 1e-3, f"{label}: angles differ by >= 1e-3 deg")
    require(n_desc <= max(5, n // 100) and bits.max(initial=0) <= 4,
            f"{label}: descriptors beyond the trig bound")
    return (f"ints equal, max angle diff {ang:.3g} deg, {n_desc} descriptors differ "
            f"(max {int(bits.max(initial=0))} bits)")


def phase_fisheye(card: str, port, bench) -> tuple:
    """Phase 14: the fisheye-inertial path at the TUM-VI configuration.
    Returns the System's front-end and three of its pairs on the card."""
    from orbslam3_tpu_torch.cameras.models import KannalaBrandt8
    from orbslam3_tpu_torch.frontend import fisheye
    from orbslam3_tpu_torch.slam.system import FRONT_END_STREAM_TAG, System
    from orbslam3_tpu_torch.tools import tumvi_scene

    with tempfile.TemporaryDirectory() as tmp:
        fis = System.from_files(None, tumvi_scene.write_settings(tmp), sensor=System.IMU_STEREO,
                                device="cuda")
    require(isinstance(fis.camera, KannalaBrandt8) and isinstance(fis.camera2, KannalaBrandt8)
            and fis.lapping1 == (0.0, 511.0) and fis.lapping2 == (0.0, 511.0)
            and fis.orb_params.n_features == 1000 and fis.imu_calib is not None,
            "the TUM-VI settings did not configure the fisheye-inertial System")
    t0 = time.perf_counter()
    seq = tumvi_scene.system_sequence(fis, N_FISHEYE)
    phase(f"14 rendered {N_FISHEYE} TUM-VI frames 512x512 (two KB8 cameras, IMU at 200 Hz) in "
          f"{time.perf_counter() - t0:.1f} s")
    steps = [
        (lambda k=k, il=il, ir=ir, imu=imu: fis.track_stereo(il, ir, k / tumvi_scene.FPS, imu=imu),
         tcw)
        for k, (il, ir, tcw, imu) in enumerate(seq)
    ]
    res = run_entry_point("14 track_stereo fisheye-inertial", fis, steps, FRONT_END_STREAM_TAG,
                          port, bench)
    ate = port.ate_rmse(res["est"], res["gt"])
    m = fis.atlas.get_current_map()
    both = sum(any(left >= 0 and right >= 0 for left, right in mp.observations.values())
               for mp in m.get_all_map_points())
    n_ok = sum(s.name == "OK" for s in res["states"])
    phase(f"14 track_stereo fisheye-inertial {N_FISHEYE} frames 512x512 on {card}: "
          f"{n_ok}/{N_FISHEYE} OK, {len(res['est'])} poses, VI initialised {m.imu_initialized}, "
          f"ATE RMSE {ate * 100:.4f} cm (the JAX package on the CPU, same frames: "
          f"{REF_TUMVI_ATE_CM} cm), {fis.map_stats()}, {both} map points observed by both cameras")
    require(n_ok == N_FISHEYE and len(res["est"]) == N_FISHEYE,
            f"fisheye frames not tracked: {[s.name for s in res['states']]}")
    require(m.imu_initialized, "visual-inertial initialisation never completed")
    require(ate < 0.012, f"fisheye-inertial ATE RMSE {ate} m >= 1.2 cm")
    require(both > 100, f"only {both} map points observed by both cameras")
    require(res["launches"] == {k: FISHEYE_PER_FRAME.get(k, 0) * N_FISHEYE
                                for k in res["launches"]},
            f"expected {FISHEYE_PER_FRAME} launches per fisheye frame, got {res['launches']}")
    phase(f"14 kernel launches per frame: "
          f"{ {k: v / N_FISHEYE for k, v in res['launches'].items() if v} }")

    # one frame on the card against the CPU, and fused against default
    il, ir, _, _ = seq[N_FISHEYE // 2]
    lap = (fis.lapping1, fis.lapping2)

    def block(feats):  # both cameras' dicts as packed rows, for the comparison
        rows = []
        for f in feats:
            n = len(f["kps"])
            rows.append(np.concatenate([
                f["kps"], f["response"][:, None], f["angle"][:, None],
                f["octave"][:, None].astype(np.float32), np.ones((n, 1), np.float32),
                np.full((n, 2), -1, np.float32), f["desc"].astype(np.float32),
            ], axis=1))
        return np.concatenate(rows)

    def pair(device, fused=port.FusedKernels()):
        feats = fisheye.extract_fisheye_pair(il, ir, fis.orb_params, *lap, device=device,
                                             fused=fused)
        return [f["mono_index"] for f in feats], block(feats)

    (mono_card, on_card), (mono_cpu, on_cpu) = pair("cuda"), pair("cpu")
    require(mono_card == mono_cpu and on_card.shape == on_cpu.shape,
            "fisheye card vs CPU: keypoint counts or lapping split differ")
    summary = compare_card_cpu("fisheye card vs CPU", on_card, on_cpu, len(on_cpu))
    phase(f"14 extract_fisheye_pair card vs CPU: {len(on_cpu)} keypoints of both cameras, "
          f"{summary}")
    mono_fused, on_fused = pair("cuda", port.FusedKernels(True, True, True))
    cols = [c for c in range(on_card.shape[1]) if not np.array_equal(on_card[:, c], on_fused[:, c])]
    require(mono_fused == mono_card and on_fused.shape == on_card.shape and not cols,
            f"fisheye fused != default in columns {cols}")
    phase("14 extract_fisheye_pair under FusedKernels(True, True, True) equal to the default")
    pairs = [torch.from_numpy(np.stack(seq[k][:2])).cuda() for k in (0, N_FISHEYE // 2, N_FISHEYE - 1)]
    return fis._front_end(seq[0][0].shape), pairs


def phase_batch(frames, poses, stats, fe_ms, card: str, port, bench) -> None:
    """Phase 15: batched prefetch against phase 4's per-frame run."""
    from orbslam3_tpu_torch.slam.system import BATCH_STREAM_TAG, FRONT_END_STREAM_TAG, System

    camera = port.Pinhole([FX, FX, W / 2, H / 2])

    def per_frame_windows() -> float:
        """Median per-frame stream window of the same frames at this point
        of the process (host-bound windows drift over a long process)."""
        sysp = System(camera, FX * BASELINE, port.PyramidParams(), device="cuda")
        bench.records.pop(FRONT_END_STREAM_TAG, None)
        for l, r, _ in frames:
            sysp._extract_stereo(l, r)
        sysp.shutdown()
        return statistics.median(bench.records[FRONT_END_STREAM_TAG])

    before = per_frame_windows()
    sysb = System(camera, FX * BASELINE, port.PyramidParams(), device="cuda")
    bench.records.pop(BATCH_STREAM_TAG, None)
    port.reset_kernel_launches()
    got = []
    t0 = time.perf_counter()
    for i in range(0, N_FRAMES, BATCH):
        handles = sysb.prefetch_stereo_batch([(l, r) for l, r, _ in frames[i : i + BATCH]])
        for j, handle in enumerate(handles):
            got.append(sysb.track_stereo_prefetched(handle, timestamp=(i + j) / 20.0))
    wall = (time.perf_counter() - t0) * 1e3 / N_FRAMES
    launches = port.kernel_launches()
    got_stats = sysb.map_stats()
    sysb.shutdown()
    batch_ms = bench.records[BATCH_STREAM_TAG]
    after = per_frame_windows()
    phase(f"15 prefetch_stereo_batch {N_FRAMES} frames {W}x{H} in windows of {BATCH} on {card}: "
          f"batch stream window per frame median {statistics.median(batch_ms):.4f} ms "
          f"({len(batch_ms)} windows) against phase 4's per-frame "
          f"{statistics.median(fe_ms):.4f} ms and the per-frame front-end's just before / after "
          f"{before:.4f} / {after:.4f} ms; wall {wall:.4f} ms/frame; launches {launches}")
    require(len(got) == len(poses) == N_FRAMES and all(p is not None for p in got),
            "batched prefetch lost frames")
    diff = [k for k, (a, b) in enumerate(zip(got, poses)) if not np.array_equal(a.matrix(), b.matrix())]
    require(not diff, f"batched prefetch poses differ from track_stereo's at frames {diff}")
    require(got_stats == stats, f"batched prefetch map {got_stats} != track_stereo's {stats}")
    require(launches == {k: STEREO_PER_FRAME.get(k, 0) * N_FRAMES for k in launches},
            f"expected {STEREO_PER_FRAME} launches per batch row, got {launches}")
    phase(f"15 batched prefetch == track_stereo: {N_FRAMES} poses bit for bit, map {got_stats}")


def phase_non_flat(port) -> None:
    """Phase 16: the stereo front-end on a geometry that is not flat."""
    from orbslam3_tpu_torch.frontend import stereo_frame as sf
    from orbslam3_tpu_torch.ops.extractor import active_levels, is_flat

    params = port.PyramidParams()
    h, w = NON_FLAT_HW
    sizes = params.level_sizes(h, w)
    require(not is_flat(sizes, params, active_levels(sizes, params)), f"{h}x{w} is flat")
    cam = port.Pinhole([150.0, 150.0, w / 2, h / 2])
    pair = torch.from_numpy(np.stack(port.stereo_sequence(1, cam, BASELINE, h, w, seed=SEED)[0][:2]))
    mbf = 150.0 * BASELINE
    port.reset_kernel_launches()
    on_card = sf.front_end(params, (h, w), mbf, 150.0, "cuda")(pair.cuda()).cpu().numpy()
    launches = port.kernel_launches()
    on_cpu = sf.front_end(params, (h, w), mbf, 150.0, "cpu")(pair).numpy()
    summary = compare_card_cpu("non-flat front-end card vs CPU", on_card, on_cpu, len(on_cpu))
    valid = on_cpu[:, 5] > 0.5
    agree = [
        float((np.abs(on_card[:, c] - on_cpu[:, c]) <= 1e-5 * np.abs(on_cpu[:, c]))[valid].mean())
        for c in (6, 7)
    ]
    phase(f"16 stereo front-end {w}x{h}, {len(active_levels(sizes, params))} of {len(sizes)} "
          f"levels active (not flat): card vs CPU {int(valid.sum())} valid, {summary}, "
          f"{int((on_cpu[:, 7] > 0).sum())} depths, u_right/depth agree on "
          f"{agree[0]:.4f}/{agree[1]:.4f} of valid slots; launches {launches}")
    require(min(agree) >= 0.99, "u_right/depth agree on < 99 % of valid slots")
    require(launches == {k: NON_FLAT_PER_FRAME.get(k, 0) for k in launches},
            f"expected {NON_FLAT_PER_FRAME} launches (two cameras' windows and selections, "
            f"the SAD strips), got {launches}")


def _settings_text(cams, w: int, h: int, extra: str) -> str:
    """An ORB-SLAM3 settings file of one or two pinhole cameras."""
    lines = ['%YAML:1.0', '---', 'File.version: "1.0"', 'Camera.type: "PinHole"']
    for c, (k, dist) in enumerate(cams, start=1):
        lines += [f"Camera{c}.{n}: {v}" for n, v in zip(("fx", "fy", "cx", "cy"), k)]
        lines += [f"Camera{c}.{n}: {v}" for n, v in zip(("k1", "k2", "p1", "p2"), dist or ())]
    lines += [f"Camera.width: {w}", f"Camera.height: {h}", "Camera.fps: 20", "Camera.RGB: 1",
              "ORBextractor.nFeatures: 1000", "ORBextractor.scaleFactor: 1.2",
              "ORBextractor.nLevels: 8", "ORBextractor.iniThFAST: 20",
              "ORBextractor.minThFAST: 7"]
    return "\n".join(lines) + "\n" + extra


def _opencv_matrix(name: str, t) -> str:
    m = np.eye(4)
    m[:3, :3], m[:3, 3] = t.R, t.t
    data = ",".join(f"{v:.12f}" for v in m.reshape(-1))
    return f"{name}: !!opencv-matrix\n  rows: 4\n  cols: 4\n  dt: f\n  data: [{data}]\n"


def _write_tum(path: str, stamps, tcws) -> None:
    """Ground truth in the TUM format: t x y z qx qy qz qw of Twc."""
    from orbslam3_tpu_torch.utils.trajectory import rot_to_quat

    with open(path, "w") as f:
        for ts, tcw in zip(stamps, tcws):
            twc = tcw.inverse()
            f.write(f"{ts:.6f} " + " ".join(f"{v:.9f}" for v in (*twc.t, *rot_to_quat(twc.R)))
                    + "\n")


def _driver_run(label: str, run, n: int, traj: str, gt: str, per_frame: dict, port, bench):
    """Run a dataset driver with the kernel counts set to 0 just before and
    read just after; every frame in its trajectory file and ATE < 2 cm
    through tools.evaluate_ate; its launches per frame as `per_frame`."""
    from orbslam3_tpu_torch.examples.common import DECODE_TAG, TRACK_TAG
    from orbslam3_tpu_torch.tools.evaluate_ate import evaluate

    for tag in (DECODE_TAG, TRACK_TAG, *STAGE_TAGS):
        bench.records.pop(tag, None)
    port.reset_kernel_launches()
    t0 = time.perf_counter()
    slam = run()
    wall = time.perf_counter() - t0
    launches = port.kernel_launches()
    with open(traj) as f:
        n_saved = len([line for line in f if line.strip()])
    res = evaluate(traj, gt, False, 0.02)
    decode = bench.records[DECODE_TAG]
    track = bench.records[TRACK_TAG]
    phase(f"{label}: {n_saved}/{n} frames in the trajectory, ATE RMSE "
          f"{res.get('value', float('nan')) * 100:.4f} cm over {res.get('pairs')} pairs "
          f"(tools.evaluate_ate), {slam.map_stats()}; ms/frame: decode {sum(decode) / n:.4f} "
          f"({len(decode) // n} PNGs a frame), track median {statistics.median(track):.4f} "
          f"(after frame 0 {statistics.median(track[1:]):.4f}); driver wall {wall:.1f} s, "
          f"{wall / n * 1e3:.1f} ms a frame; "
          f"launches per frame {({k: v / n for k, v in launches.items() if v})}")
    stages = {tag: statistics.median(bench.records[tag]) for tag in STAGE_TAGS
              if bench.records.get(tag)}
    phase(f"{label}: System stages, median ms a call: "
          + ", ".join(f"{tag} {ms:.4f}" for tag, ms in stages.items()))
    require(n_saved == n and res.get("pairs") == n, f"{label}: frames missing from {traj}")
    require(res["value"] < 0.02, f"{label}: ATE RMSE {res['value']} m >= 2 cm")
    require(launches == {k: per_frame.get(k, 0) * n for k in launches},
            f"{label}: expected {per_frame} launches per frame, got {launches}")
    return slam


def _euroc_rig(port) -> tuple:
    """Phase 17's EuRoC cameras (left, right) and T_rl."""
    from orbslam3_tpu_torch.utils.lie import SE3, so3_exp

    cam_l, cam_r = (port.Pinhole(k, d) for k, d in EUROC_CAMS)
    t_rl = SE3(so3_exp(np.array([0.004, -0.006, 0.002])), np.array([-0.11, 0.001, -0.0008]))
    return cam_l, cam_r, t_rl


def _stereo_settings(t_rl) -> str:
    """Phase 17's stereo settings file text (the distorted EuRoC rig)."""
    rig = "Stereo.ThDepth: 60.0\n" + _opencv_matrix("Stereo.T_c1_c2", t_rl.inverse())
    return _settings_text(EUROC_CAMS, W, H, rig)


def phase_euroc(card: str, port, bench) -> None:
    """Phase 17: a EuRoC ASL tree through examples.run_euroc on the card."""
    from orbslam3_tpu_torch.examples import run_euroc
    from orbslam3_tpu_torch.frontend.rectify import remap_bilinear
    from orbslam3_tpu_torch.utils import imageio
    from orbslam3_tpu_torch.utils.lie import SE3, so3_exp
    from orbslam3_tpu_torch.utils.synth import imu_samples_between

    cam_l, cam_r, t_rl = _euroc_rig(port)
    tbc = SE3(so3_exp(np.array([0.0, 0.0, np.pi / 2])), np.array([-0.0216, -0.0647, 0.0098]))
    t0 = time.perf_counter()
    frames = port.stereo_sequence(N_FRAMES, cam_l, 0.11, H, W, seed=3, camera_r=cam_r, T_rl=t_rl)
    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "mav0")
        stamps = [EUROC_T0_NS + int(k / 20.0 * 1e9) for k in range(N_FRAMES)]
        for cam, side in (("cam0", 0), ("cam1", 1)):
            os.makedirs(os.path.join(seq, cam, "data"))
            with open(os.path.join(seq, cam, "data.csv"), "w") as f:
                f.write("#timestamp [ns],filename\n")
                for ns, fr in zip(stamps, frames):
                    imageio.imwrite(os.path.join(seq, cam, "data", f"{ns}.png"), fr[side])
                    f.write(f"{ns},{ns}.png\n")
        os.makedirs(os.path.join(seq, "imu0"))
        with open(os.path.join(seq, "imu0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
            for k in range(N_FRAMES - 1):
                acc, gyro, dts = imu_samples_between(k, k + 1, Tbc=tbc)
                t = stamps[k]
                for a, g, dt in zip(acc, gyro, dts):
                    t += int(dt * 1e9)
                    f.write(",".join(str(v) for v in (t, *g, *a)) + "\n")
        stereo = os.path.join(tmp, "EuRoC.yaml")
        rig = "Stereo.ThDepth: 60.0\n" + _opencv_matrix("Stereo.T_c1_c2", t_rl.inverse())
        with open(stereo, "w") as f:
            f.write(_stereo_settings(t_rl))
        inertial = os.path.join(tmp, "EuRoC_VI.yaml")
        with open(inertial, "w") as f:
            f.write(_settings_text(EUROC_CAMS, W, H, rig + (
                "IMU.NoiseGyro: 1.7e-4\nIMU.NoiseAcc: 2.0e-3\nIMU.GyroWalk: 1.9e-5\n"
                "IMU.AccWalk: 3.0e-3\nIMU.Frequency: 200\n") + _opencv_matrix("IMU.T_b_c1", tbc)))
        phase(f"17 wrote a EuRoC ASL tree of {N_FRAMES} distorted {W}x{H} stereo frames and "
              f"{(N_FRAMES - 1) * 10} IMU samples with utils.imageio in "
              f"{time.perf_counter() - t0:.1f} s")
        runs = (
            ("17 run_euroc stereo", stereo, "stereo", {}),
            ("17 run_euroc stereo-inertial", inertial, "stereo-inertial", {}),
            (f"17 run_euroc stereo --batch {EUROC_BATCH}", stereo, "stereo",
             {"batch": EUROC_BATCH}),
        )
        # ground truth in the rectified left camera's frame (Tcw_rect = R1 Tcw)
        gt = os.path.join(tmp, "gt.txt")
        r1 = SE3(_rectifier_of(stereo, "stereo").R1, np.zeros(3))
        _write_tum(gt, [ns * 1e-9 for ns in stamps], [r1 * f[2] for f in frames])
        for i, (label, settings, sensor, kw) in enumerate(runs):
            out = os.path.join(tmp, f"run{i}")
            os.makedirs(out)
            slam = _driver_run(
                label, lambda: run_euroc.main(seq, settings, None, sensor, device="cuda",
                                              out_dir=out, **kw),
                N_FRAMES, os.path.join(out, "CameraTrajectory.txt"), gt,
                STEREO_PER_FRAME, port, bench,
            )
        rect = slam.rectifier
        pair = torch.from_numpy(np.stack(frames[0][:2]))
        maps = [torch.from_numpy(np.stack(m))
                for m in ((rect.map1x, rect.map2x), (rect.map1y, rect.map2y))]
        dev_pair, dev_maps = pair.cuda(), [m.cuda() for m in maps]
        require(torch.equal(remap_bilinear(dev_pair, *dev_maps).cpu(), remap_bilinear(pair, *maps)),
                "the remap on the card differs from the CPU's")
        remap = cuda_ms(lambda: remap_bilinear(dev_pair, *dev_maps))
        upload = cuda_ms(lambda: pair.cuda())
        phase(f"17 device remap of a frame's two {W}x{H} images (one pass) on {card}: {remap:.4f} ms "
              f"(CUDA events), equal to the CPU's; their upload from pageable memory "
              f"{upload:.4f} ms")
        # the rectifier's remap as a CUDA graph (StereoRectifier.rectify): a
        # fresh rectifier captures at its first frame and replays after it
        fresh = _rectifier_of(stereo, "stereo")
        for k, fr in enumerate(frames):
            got = torch.stack(fresh.rectify(fr[0], fr[1], "cuda"))
            want = remap_bilinear(torch.from_numpy(np.stack(fr[:2])).cuda(), *dev_maps)
            require(torch.equal(got, want), f"17 the graphed remap differs from eager at frame {k}")
        graph = fresh._device_maps[torch.device("cuda")].graphs["remap"]
        replays = graph.replays
        require(replays == N_FRAMES - 1, f"17 remap graph replays {replays}")
        graphed = cuda_ms(lambda: graph(dev_pair))
        phase(f"17 the rectifier's remap as a CUDA graph on {card}: == eager bit for bit on "
              f"{N_FRAMES} frames (captured at frame 0 in {graph.capture_ms:.1f} ms, then "
              f"{replays} replays); a pair, the window between CUDA events: graphed "
              f"{graphed:.4f} ms (input copy, replay, output clone), eager {remap:.4f} ms")


def _rectifier_of(settings: str, sensor: str):
    """The rectifier System.from_files builds from `settings`."""
    from orbslam3_tpu_torch.utils.settings import load_settings

    return load_settings(settings, sensor).make_rectifier()


def phase_tum_rgbd(card: str, port, bench) -> None:
    """Phase 18: a TUM-RGBD tree through examples.run_tum_rgbd under --fused."""
    from orbslam3_tpu_torch.examples import run_tum_rgbd
    from orbslam3_tpu_torch.utils import imageio

    camera = port.Pinhole([FX, FX, W / 2, H / 2])
    frames = port.rgbd_sequence(N_FRAMES, camera, H, W, seed=2, depth_noise=0.002,
                                depth_factor=5000.0)
    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "seq")
        os.makedirs(os.path.join(seq, "rgb"))
        os.makedirs(os.path.join(seq, "depth"))
        stamps = [1305031100.0 + k / 20.0 for k in range(N_FRAMES)]
        with open(os.path.join(seq, "associations.txt"), "w") as f:
            for ts, (img, depth, _) in zip(stamps, frames):
                # colour whose channels differ: reading it as grey runs libpng's formula
                bgr = np.stack([img, img, np.clip(img.astype(int) + 9, 0, 255)], -1)
                imageio.imwrite(os.path.join(seq, "rgb", f"{ts:.6f}.png"), bgr.astype(np.uint8))
                imageio.imwrite(os.path.join(seq, "depth", f"{ts:.6f}.png"),
                                np.clip(depth, 0, 65535).astype(np.uint16))
                f.write(f"{ts:.6f} rgb/{ts:.6f}.png {ts:.6f} depth/{ts:.6f}.png\n")
        settings = os.path.join(tmp, "TUM.yaml")
        with open(settings, "w") as f:
            f.write(_settings_text([([FX, FX, W / 2, H / 2], None)], W, H,
                                   f"Camera.bf: {FX * 0.08}\nStereo.ThDepth: 40.0\n"
                                   "RGBD.DepthMapFactor: 5000.0\n"))
        gt = os.path.join(tmp, "gt.txt")
        _write_tum(gt, stamps, [f[2] for f in frames])
        _driver_run(
            "18 run_tum_rgbd --fused detect,moments,sample",
            lambda: run_tum_rgbd.main(seq, settings, device="cuda",
                                      fused=port.FusedKernels(True, True, True), out_dir=tmp),
            N_FRAMES, os.path.join(tmp, "CameraTrajectory.txt"), gt, FUSED_PER_FRAME, port, bench,
        )


def phase_entry_and_bench(card: str) -> None:
    """Phase 19: the entry hook on the card, and the bench at a reduced
    frame count."""
    from orbslam3_tpu_torch import bench as port_bench
    from orbslam3_tpu_torch.entry import entry

    fn, (pair,) = entry("cuda")
    cpu_fn, (cpu_pair,) = entry("cpu")
    got, want = fn(pair), cpu_fn(cpu_pair)
    for side in ("left", "right"):
        g, w = getattr(got, side), getattr(want, side)
        for col in ("xy", "octave", "response", "valid"):
            require(torch.equal(getattr(g, col).cpu(), getattr(w, col)),
                    f"entry(): {side} {col} on the card differs from the CPU's")
    require(torch.equal((got.u_right >= 0).cpu(), want.u_right >= 0), "entry(): matches differ")
    phase(f"19 entry(): the stereo step on {pair.device} 120x160, 4 levels, 256 features: "
          f"{int(got.left.valid.sum())} left keypoints, {int((got.u_right >= 0).sum())} "
          f"matched; integer columns equal to the CPU's")
    r = port_bench.measure(BENCH_FRAMES, warmup=3, batch=EUROC_BATCH)
    phase(f"19 bench at {BENCH_FRAMES} frames on {card}: stream window median "
          f"{r['window_ms']:.4f} ms/frame graphed, {r['eager_window_ms']:.4f} eager, batched "
          f"({EUROC_BATCH}) {r['batch_ms']:.4f} ms/frame")
    phase("19 bench headline: " + json.dumps(port_bench.final_line(r["wall_ms"])))


def _tool_lines(fn) -> tuple:
    """(fn's result, the lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    return result, buf.getvalue().splitlines()


# phase 22: a viewer run in a process that refuses cv2, PIL and matplotlib, and the
# texture every synthetic sequence draws
_NO_CV2_RUN = """
import json, os, sys, time


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "orbslam3_tpu", "cv2", "PIL", "matplotlib"):
            raise ImportError("the port must not import " + name)
        return None


sys.meta_path.insert(0, _Refuse())
import numpy as np
from orbslam3_tpu_torch.slam.system import System
from orbslam3_tpu_torch.utils import imageio
from orbslam3_tpu_torch.utils.synth import make_texture

settings, frames, out, size = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
t0 = time.perf_counter()
np.save(os.path.join(out, "texture.npy"), make_texture(size, 0))
texture_s = time.perf_counter() - t0
slam = System.from_files(None, settings, "stereo", use_viewer=True,
                         viewer_dir=os.path.join(out, "viewer"), device="cuda")
poses = [slam.track_stereo(l, r, k / 20.0) for k, (l, r) in enumerate(np.load(frames))]
slam.shutdown()
pngs = {n: list(imageio.imread(os.path.join(out, "viewer", n), unchanged=True).shape)
        for n in sorted(os.listdir(os.path.join(out, "viewer")))}
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "orbslam3_tpu", "cv2", "PIL", "matplotlib"))
print(json.dumps({"texture_s": texture_s, "tracked": sum(p is not None for p in poses),
                  "pngs": pngs, "leaked": leaked}))
"""
VIEWER_FRAMES = 4
TEXTURE_SIZE = 2048  # the soak's


def _cv2_drawings(size: int, seed: int, text: str) -> tuple:
    """cv2's side of phase 22: make_texture's texture with its polygons
    drawn by cv2.fillPoly, as the JAX package draws them (the port's own
    function with only its fill_poly swapped for cv2's), its host wall, the
    text drawn by cv2.putText in FONT_HERSHEY_PLAIN, and cv2's version."""
    import cv2
    from orbslam3_tpu_torch.utils import synth

    def cv2_fill(img, pts, value):
        cv2.fillPoly(img, [pts], value)

    t0 = time.perf_counter()
    with mock.patch.object(synth, "fill_poly", cv2_fill):
        texture = synth.make_texture(size, seed)
    texture_s = time.perf_counter() - t0
    drawn = np.zeros((24, 1100), np.uint8)
    cv2.putText(drawn, text, (10, 16), cv2.FONT_HERSHEY_PLAIN, 1, 255, 1)
    return texture, texture_s, drawn, cv2.__version__


def phase_viewer_and_texture(card: str, port) -> None:
    """Phase 22: System.from_files(use_viewer=True) on phase 17's rig in a
    process that refuses cv2, PIL and matplotlib; make_texture there against the
    cv2.fillPoly drawing here, where cv2 is importable."""
    from orbslam3_tpu_torch.utils import raster

    cam_l, cam_r, t_rl = _euroc_rig(port)
    frames = port.stereo_sequence(VIEWER_FRAMES, cam_l, 0.11, H, W, seed=3, camera_r=cam_r,
                                  T_rl=t_rl)
    with tempfile.TemporaryDirectory() as tmp:
        settings, pairs = os.path.join(tmp, "EuRoC.yaml"), os.path.join(tmp, "pairs.npy")
        with open(settings, "w") as f:
            f.write(_stereo_settings(t_rl))
        np.save(pairs, np.stack([np.stack(fr[:2]) for fr in frames]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _NO_CV2_RUN, settings, pairs, tmp, str(TEXTURE_SIZE)],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__))),
        )
        require(proc.returncode == 0, f"22 the viewer run failed: {proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        pngs = res["pngs"]
        frame_pngs = [n for n in pngs if n.startswith("frame_")]
        require(not res["leaked"], f"22 loaded {res['leaked']}")
        require(res["tracked"] == VIEWER_FRAMES, f"22 tracked {res['tracked']}/{VIEWER_FRAMES}")
        require(frame_pngs and all(pngs[n] == [H, W, 3] for n in frame_pngs)
                and any(n.startswith("map_") and pngs[n][2] == 3 for n in pngs),
                f"22 viewer PNGs {pngs}")
        phase(f"22 System.from_files(use_viewer=True) on {card}, cv2, PIL and matplotlib refused: "
              f"{VIEWER_FRAMES}/{VIEWER_FRAMES} stereo frames tracked, the viewer wrote "
              f"{len(pngs)} PNGs that utils.imageio decodes ({len(frame_pngs)} frames of "
              f"{W}x{H}x3, the rest maps); process wall {time.perf_counter() - t0:.1f} s")
        if importlib.util.find_spec("cv2") is None:
            phase("22 cv2 is not importable here: make_texture is compared with cv2.fillPoly on "
                  "the CPU only (tests/test_torch_raster.py)")
            return
        printable = "".join(chr(c) for c in range(32, 127))
        want, cv2_s, text_cv2, version = _cv2_drawings(TEXTURE_SIZE, 0, printable)
        require(np.array_equal(np.load(os.path.join(tmp, "texture.npy")), want),
                "22 make_texture without cv2 differs from the cv2.fillPoly drawing")
    phase(f"22 make_texture({TEXTURE_SIZE}, 0) with cv2 refused == the same texture drawn "
          f"with cv2.fillPoly, bit for bit; host wall of the whole texture {res['texture_s']:.3f} s "
          f"(utils/raster.fill_poly) against {cv2_s:.3f} s (cv2.fillPoly)")
    text_port = raster.put_text(np.zeros_like(text_cv2), printable, (10, 16), 255)
    same = np.array_equal(text_port, text_cv2)
    phase(f"22 cv2 {version} here: its putText of the 95 printable characters "
          f"{'equals' if same else 'differs from'} utils/raster.put_text's "
          f"({int((text_port != text_cv2).sum())} pixels differ; cv2 draws "
          f"{len(np.unique(text_cv2))} grey levels, the port's cv2 5.x glyph table "
          f"{len(np.unique(text_port))}); not required: the text is cv2 5.x's")


def phase_tools(card: str, port) -> None:
    """Phase 21: the tools that measure the whole System, on the card."""
    from orbslam3_tpu_torch.slam import matchers
    from orbslam3_tpu_torch.tools import bench_matchers, bench_stages, bench_system

    port.reset_kernel_launches()
    (per_frame, wall), _ = _tool_lines(lambda: bench_system.run(TOOL_FRAMES))
    launches = port.kernel_launches()
    phase(f"21 bench_system {TOOL_FRAMES} frames on {card}: {json.dumps(per_frame)}")
    phase(f"21 bench_system on {card}: {json.dumps(wall)}")
    require(per_frame["tracked"] == TOOL_FRAMES and per_frame["ate_rmse_m"] < 0.01,
            f"bench_system: {per_frame['tracked']}/{TOOL_FRAMES} tracked, ATE "
            f"{per_frame['ate_rmse_m']} m")
    require(launches == {k: STEREO_PER_FRAME.get(k, 0) * TOOL_FRAMES for k in launches},
            f"bench_system: launches {launches} over {TOOL_FRAMES} frames")
    phase(f"21 bench_system kernel launches in the run: {launches}")

    stages, lines = _tool_lines(lambda: bench_stages.run())
    for line in lines:
        phase(f"21 bench_stages on {card}: {line}")
    require(len(stages) == 15 and all(0 < v < 1e3 for v in stages.values()),
            f"bench_stages: {stages}")

    for n in bench_matchers.SIZES:
        (line,), _ = _tool_lines(lambda: bench_matchers.run([n]))
        frame, mps = bench_matchers.make_scene(n)
        host = bench_matchers.matched(
            lambda: matchers.search_by_projection_local_map(frame, mps, th=2.0), frame)
        dev = bench_matchers.matched(lambda: matchers.search_by_projection_local_map_device(
            frame, mps, th=2.0, device=torch.device("cuda")), frame)
        require(np.array_equal(host, dev), f"bench_matchers {n}: device matches != host's")
        phase(f"21 bench_matchers on {card}: {json.dumps(line)}; device matches == host's "
              f"({int((host >= 0).sum())} keypoints matched)")

    # trace_ops in a process of its own: late in a long process a
    # profiler trace can miss device events (phases 6 and 11 meet that)
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "orbslam3_tpu_torch.tools.trace_ops", "10", "--frames=1"],
        capture_output=True, text=True, cwd=here, timeout=600,
        env=dict(os.environ, PYTHONPATH=here),
    )
    lines = [line for line in proc.stdout.splitlines() if not line.startswith("USDT:")]
    out_dir = os.path.join(here, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_trace_ops.txt"), "w") as f:
        f.write("\n".join(lines) + "\n" + proc.stderr[-4000:])
    require(proc.returncode == 0 and lines[0] == card,
            f"trace_ops exited {proc.returncode}: {proc.stderr[-2000:]}")
    start = next((i for i, line in enumerate(lines) if line.startswith("graphed frame")), None)
    require(start is not None, "trace_ops printed no graphed frame")
    for line in lines[start:start + 13]:
        phase(f"21 trace_ops on {card}: {line}")


def phase_graphs(frames, poses, rgbd_frames, fisheye_program, card: str, port, bench) -> None:
    """Phase 20: each frame program's CUDA graph against its eager program
    on the card, and what the graphs do to the stream window and the wall."""
    import dataclasses

    from orbslam3_tpu_torch.frontend import stereo_frame as sf
    from orbslam3_tpu_torch.ops import extractor as ex
    from orbslam3_tpu_torch.slam.system import FRONT_END_STREAM_TAG, System
    from orbslam3_tpu_torch.utils import launches
    from orbslam3_tpu_torch.utils.frame_graph import FrameGraph

    dev = torch.device("cuda")
    params = port.PyramidParams()
    fused = port.FusedKernels(True, True, True)
    mbf = FX * BASELINE
    pairs = [torch.from_numpy(np.stack(f[:2])).to(dev) for f in frames]
    h, w = NON_FLAT_HW
    cam_nf = port.Pinhole([150.0, 150.0, w / 2, h / 2])
    nf_pairs = [torch.from_numpy(np.stack(f[:2])).to(dev)
                for f in port.stereo_sequence(3, cam_nf, BASELINE, h, w, seed=SEED)]
    fe = sf.front_end(params, (H, W), mbf, FX, "cuda")
    fe_fused = sf.front_end(params, (H, W), mbf, FX, "cuda", fused)
    fe_nf = sf.front_end(params, NON_FLAT_HW, 150.0 * BASELINE, 150.0, "cuda")
    fe_fish, fish_pairs = fisheye_program
    ini = dataclasses.replace(params, n_features=5 * params.n_features)
    x_ini = ex.feature_extractor(ini, (H, W), fused, "cuda")  # phase 8's init extractor
    x_one = ex.feature_extractor(params, (H, W), fused, "cuda")  # phases 8 and 9
    x_default = ex.feature_extractor(params, (H, W), port.FusedKernels(), "cuda")
    rgbd_imgs = [torch.from_numpy(np.ascontiguousarray(f[0])).to(dev) for f in rgbd_frames[:3]]
    programs = (
        ("stereo default", fe, "packed", fe, fe.eager, pairs[:3]),
        ("stereo fused", fe_fused, "packed", fe_fused, fe_fused.eager, pairs[:3]),
        ("non-flat stereo 120x160", fe_nf, "packed", fe_nf, fe_nf.eager, nf_pairs),
        ("fisheye pair block 512x512", fe_fish, "pair_block", fe_fish.pair_block,
         fe_fish.pair_block_eager, fish_pairs),
        ("mono init extractor (5000, fused)", x_ini, "packed", x_ini.packed, x_ini.eager,
         [p[0] for p in pairs[:3]]),
        ("mono / RGB-D extractor (1000, fused)", x_one, "packed", x_one.packed, x_one.eager,
         [p[0] for p in pairs[:3]] + rgbd_imgs),
        ("mono extractor (1000, default)", x_default, "packed", x_default.packed,
         x_default.eager, [p[0] for p in pairs[:3]]),
    )
    pool_total = 0
    for label, module, name, graphed, eager, inputs in programs:
        for x in inputs:
            with launches.recorded() as by_graph:
                got = graphed(x)
            with launches.recorded() as by_eager:
                want = eager(x)
            require(torch.equal(got, want), f"20 {label}: graphed != eager")
            require(by_graph == by_eager,
                    f"20 {label}: launches graphed {by_graph} != eager {by_eager}")
        g = module.graphs[name]
        pool_total += g.pool_bytes
        phase(f"20 {label}: graphed == eager bit for bit on {len(inputs)} inputs, launches a "
              f"frame {by_graph}; capture {g.capture_ms:.1f} ms (first call's eager run "
              f"{g.warmup_ms:.1f} ms), pool {g.pool_bytes / 2**20:.1f} MiB, {g.replays} replays")
    phase(f"20 the graphs' pools together {pool_total / 2**20:.1f} MiB; the card's reserved "
          f"memory {torch.cuda.memory_reserved() / 2**20:.1f} MiB")

    # every batch row equal to a single frame
    rows = fe.batch(torch.stack(pairs[:BATCH]))
    for b in range(BATCH):
        require(torch.equal(rows[b], fe.eager(pairs[b])), f"20 batch row {b} != a single frame")
    phase(f"20 StereoFrontEnd.batch: every one of {BATCH} rows == the eager single frame")

    # the stream window per frame over phase 4's frames, in turns
    turns = {"eager": [], "graphed": []}
    for mode in ("eager", "graphed", "graphed", "eager"):
        program = fe.eager if mode == "eager" else fe
        turns[mode] += [window_ms(lambda: program(p)) for p in pairs]
    batches = [torch.stack(pairs[i : i + BATCH]) for i in range(0, N_FRAMES - BATCH + 1, BATCH)]
    batch_windows = [window_ms(lambda: fe.batch(b)) for b in batches]
    phase(f"20 stereo front-end stream window per frame on {card}, {N_FRAMES} frames x 2 turns: "
          f"eager median {statistics.median(turns['eager']):.4f} ms, graphed median "
          f"{statistics.median(turns['graphed']):.4f} ms; batch of {BATCH} "
          f"{statistics.median(batch_windows) / BATCH:.4f} ms per frame")

    # track_stereo over the 30 frames, eager and graphed in turns: phase 4's
    # poses bit for bit each time
    camera = port.Pinhole([FX, FX, W / 2, H / 2])
    walls = {"eager": [], "graphed": []}
    windows = {"eager": [], "graphed": []}
    for mode in ("eager", "graphed", "graphed", "eager"):
        run = System(camera, mbf, params, device="cuda")
        if mode == "eager":
            run._front_end = lambda hw: fe.eager  # every frame op by op
        bench.records.pop(FRONT_END_STREAM_TAG, None)
        got = []
        for k, (img_l, img_r, _) in enumerate(frames):
            t0 = time.perf_counter()
            got.append(run.track_stereo(img_l, img_r, timestamp=k / 20.0))
            walls[mode].append((time.perf_counter() - t0) * 1e3)
        run.shutdown()
        windows[mode] += bench.records[FRONT_END_STREAM_TAG][1:]
        walls[mode] = walls[mode][:-N_FRAMES] + walls[mode][-N_FRAMES + 1 :]  # frame 0 out
        require(all(np.array_equal(a.matrix(), b.matrix()) for a, b in zip(got, poses))
                and len(got) == len(poses), f"20 track_stereo {mode}: poses differ from phase 4's")
    phase(f"20 track_stereo {N_FRAMES} frames x 2 turns on {card}, after frame 0: wall median "
          f"eager {statistics.median(walls['eager']):.4f} ms, graphed "
          f"{statistics.median(walls['graphed']):.4f} ms; front-end stream window median eager "
          f"{statistics.median(windows['eager']):.4f} ms, graphed "
          f"{statistics.median(windows['graphed']):.4f} ms; phase 4's poses bit for bit in "
          f"every run")

    # prefetch on the side stream interleaved with track_stereo on the
    # current one, both replaying one graph
    inter = System(camera, mbf, params, device="cuda")
    got = []
    for k in range(0, N_FRAMES, 2):
        ahead = inter.prefetch_stereo(frames[k + 1][0], frames[k + 1][1])
        got.append(inter.track_stereo(frames[k][0], frames[k][1], timestamp=k / 20.0))
        host, done, _, _ = ahead
        done.synchronize()
        require(torch.equal(host, fe.eager(pairs[k + 1]).cpu()),
                f"20 prefetch of frame {k + 1} != the eager program")
        got.append(inter.track_stereo_prefetched(ahead, timestamp=(k + 1) / 20.0))
    inter.shutdown()
    require(len(got) == N_FRAMES and all(np.array_equal(a.matrix(), b.matrix())
                                         for a, b in zip(got, poses)),
            "20 prefetch interleaved with track_stereo: poses differ from phase 4's")
    phase(f"20 prefetch_stereo (side stream) interleaved with track_stereo over {N_FRAMES} "
          f"frames: every prefetched block == eager, phase 4's poses bit for bit")

    # no fallback: a program with a host read fails its capture, twice
    calls = []

    def host_read(x):
        calls.append(1)
        return x * int((x > 0).sum().item())

    bad = FrameGraph(host_read, dev)
    x = torch.arange(8, dtype=torch.float32, device=dev)
    for _ in range(2):
        try:
            bad(x)
        except RuntimeError as e:
            msg = str(e).splitlines()[0][:100]
        else:
            raise AssertionError("20 a capture with .item() inside did not raise")
        require(bad.graph is None, "20 a failed capture left a graph")
    require(len(calls) == 4, f"20 expected two eager runs and two captures, got {len(calls)} calls")
    require(torch.equal(fe(pairs[0]), fe.eager(pairs[0])), "20 the card after a failed capture")
    phase(f"20 a program with .item() inside: the capture raised at each of two calls "
          f"({msg}), no graph kept, nothing run in its place; the card still replays")


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
    from orbslam3_tpu_torch.tools import bench_match_kernels as bmk
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
    phase(f"1 cv2 importable here: {importlib.util.find_spec('cv2') is not None} "
          f"(the port needs none: utils.imageio reads and writes PNGs, the remap and the "
          f"drawing are its own)")

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

    # K1, K2 and K3 (tools/bench_match_kernels.py): bit for bit on the main
    # path's inputs (a stereo frame's 16 score maps and the mono
    # initialisation's 5000-feature call for K1; the frame's features,
    # strips and pair block for K2 and K3) and at the edge cases
    match_inputs = bmk.path_inputs(dev)
    path = bmk.path_errs(match_inputs)
    edges = {"grid_pool": bmk.k1_edge_errs(dev), "stereo_hamming": bmk.k2_edge_errs(dev),
             "sad_refine": bmk.k3_edge_errs(dev)}
    labels = {"grid_pool": "K1", "stereo_hamming": "K2", "sad_refine": "K3"}
    match_err = {}
    for name, label in labels.items():
        errs = {**path[name], **edges[name]}
        match_err[name] = max(errs.values())
        bad = {k: e for k, e in errs.items() if e != 0}
        require(not bad, f"{label} {name}: kernel != twin at {bad}")
        phase(f"3 {label} {name}: bit-exact against its twin on the main path "
              f"({', '.join(path[name])}) and at {len(edges[name])} edge cases "
              f"({', '.join(edges[name])})")
    for name, t in bmk.time_kernels(match_inputs).items():
        extra = {k: v for k, v in t.items()
                 if k not in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        phase(f"3 {labels[name]} {name} at the main path's shapes (a stereo frame): device time "
              f"kernel {t['ms']:.4f} ms, twin {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}), share {t['bound_ms'] / t['ms']:.3f}; {extra}")
        report[name] = dict(max_abs_err=match_err[name], ms=t["ms"], plain_ms=t["plain_ms"],
                            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
                            **extra)

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
    stereo_stats = sysm.map_stats()
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
    require(launches == {k: STEREO_PER_FRAME.get(k, 0) * N_FRAMES for k in launches}
            and set(STEREO_PER_FRAME) <= set(launches),
            f"expected {STEREO_PER_FRAME} launches per frame, got {launches}")
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
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as f:
        for mode, fn in (("eager", lambda: fe.eager(pair)), ("graphed", lambda: fe(pair))):
            window, ops, n_ops = device_profile(fn, reps=5)
            busy = sum(ops.values())
            top = sorted(ops.items(), key=lambda kv: -kv[1])
            if not ops:
                phase(NO_TRACE)
            phase(f"6 front-end {mode}: device busy (profiler) {busy:.4f} ms/frame in a stream "
                  f"window of {window:.4f} ms/frame ({100 * busy / window:.1f} % busy), "
                  f"{n_ops:.0f} device ops/frame")
            for key, ms in top[:8]:
                phase(f"6   {mode} {ms:.4f} ms/frame  {key[:100]}")
            f.write(f"# {card}; front-end {mode} device ms per frame by op, 752x480 stereo\n")
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
    per_frame = {k: FUSED_PER_FRAME.get(k, 0) for k in port.kernel_launches()}
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
            f"expected {FUSED_PER_FRAME} launches per frame and no other, got {res['launches']}")
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
            f"expected {FUSED_PER_FRAME} launches per frame and no other, got {res['launches']}")
    for k, v in res["launches"].items():
        fused_launches[k] += v
    require("jax" not in sys.modules, "the port imported JAX")

    # phase 10: fused against default, one frame --------------------------
    fe_fused = sf.front_end(params, (H, W), mbf, FX, "cuda", fused)
    fe_mono_fused = ex.feature_extractor(params, (H, W), fused, "cuda")

    for label, a, b in (
        ("stereo front-end", fe(pair), fe_fused(pair)),
        ("mono extractor", fe_mono.packed(pair[0]), fe_mono_fused.packed(pair[0])),
    ):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        cols = [c for c in range(a.shape[1]) if not np.array_equal(a[:, c], b[:, c])]
        phase(f"10 {label} fused vs default: {a.shape[0]} slots, {int((a[:, 5] > 0.5).sum())} "
              f"valid, columns that differ: {cols}")
        require(a.shape == b.shape and not cols, f"{label}: fused != default in columns {cols}")

    # phase 11: device time of the front-ends, default and fused, eager and
    # graphed side by side
    for label, module, x in (
        ("stereo front-end", (fe, fe_fused), pair),
        ("mono extractor", (fe_mono, fe_mono_fused), pair[0]),
    ):
        for cfg, m in zip(("default", "fused"), module):
            graphed = m.packed if isinstance(m, ex.FeatureExtractor) else m
            cols = []
            for mode, fn in (("eager", lambda: m.eager(x)), ("graphed", lambda: graphed(x))):
                window, ops, n_ops = device_profile(fn, reps=5)
                busy = sum(ops.values())
                if not ops:
                    phase(NO_TRACE)
                cols.append(f"{mode} busy {busy:.4f} ms/frame in a stream window of "
                            f"{window:.4f} ({100 * busy / window:.1f} % busy), "
                            f"{n_ops:.0f} device ops/frame")
            phase(f"11 {label} {cfg} (profiler): " + " | ".join(cols))
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

    fisheye_program = phase_fisheye(card, port, bench)
    phase_batch(frames, est, stereo_stats, fe_ms, card, port, bench)
    phase_non_flat(port)
    phase_euroc(card, port, bench)
    phase_tum_rgbd(card, port, bench)
    phase_entry_and_bench(card)
    phase_graphs(frames, est, rgbd_frames, fisheye_program, card, port, bench)
    phase_tools(card, port)
    phase_viewer_and_texture(card, port)

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
        dict(name="grid_pool", route="cuda", source="orbslam3_tpu_torch/csrc/grid_pool.cu",
             replaces="orbslam3_tpu/ops/select.py:36", launches=launches["grid_pool"],
             **report["grid_pool"]),
        dict(name="stereo_hamming", route="cuda",
             source="orbslam3_tpu_torch/csrc/stereo_hamming.cu",
             replaces="orbslam3_tpu/frontend/stereo_frame.py:86",
             launches=launches["stereo_hamming"], **report["stereo_hamming"]),
        dict(name="sad_refine", route="cuda", source="orbslam3_tpu_torch/csrc/sad_refine.cu",
             replaces="orbslam3_tpu/frontend/stereo_frame.py:141",
             launches=launches["sad_refine"], **report["sad_refine"]),
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
