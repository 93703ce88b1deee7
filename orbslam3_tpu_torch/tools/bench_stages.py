"""Device time per stage of the stereo front-end on the card.

The port's counterpart of the reference's `tools/bench_stages.py`: the
same stages (pyramid, blur, fast, fastraw / fastnms, select, orient,
brief, mono, stereo, s:detect / s:feats), each the port's eager function
on the same 752x480 images and `PyramidParams(n_features=1000)`, and the
port's own: pool (the selection's candidate pools alone, K1 on the card)
and, under stereoparts, s:pairs and s:sad (the stereo match's pair match,
K2, and its SAD refinement with the median filter, K3, alone, on the
pair's own features and strips).  The
reference's slope method (two scans of N calls in one program) becomes
CUDA events around the replay of one CUDA graph of N calls of the stage
(`utils.device_time.device_ms`, as `chip_smoke.py` times its kernels): the
card runs the calls back to back with no host launch gap.  Each line is
ms per call.  With --device=cpu a line is the median host wall of one
call.

Usage: python -m orbslam3_tpu_torch.tools.bench_stages [stage ...]
           [--calls=N] [--device=cpu]
(no stage: all; "fastraw" prints fastraw and fastnms, "stereoparts"
s:detect, s:feats, s:pairs and s:sad)
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

STAGES = ("pyramid", "blur", "fast", "fastraw", "select", "pool", "orient", "brief", "mono",
          "stereo", "stereoparts")
H, W = 480, 752


def per_call_ms(fn, device: torch.device, calls: int) -> float:
    """Device ms per call (CUDA graph of `calls` calls) on CUDA, the median
    host wall of one call on the CPU."""
    if device.type == "cuda":
        from orbslam3_tpu_torch.utils.device_time import device_ms

        return device_ms(fn, calls=calls)
    fn()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def run(only=(), device: str = "cuda", calls: int = 20, h: int = H, w: int = W) -> dict:
    """{stage line name: ms per call} of the chosen stages (all if empty),
    each printed as it is measured."""
    from orbslam3_tpu_torch.frontend.stereo_frame import DEFAULT_FX, DEFAULT_MBF, StereoFrontEnd
    from orbslam3_tpu_torch.ops.brief import brief_descriptors, brief_sampling_image
    from orbslam3_tpu_torch.ops.extractor import (
        FeatureExtractor, build_merged_composites, detection_crops,
    )
    from orbslam3_tpu_torch.ops.fast import (
        detect_two_threshold_multi, detection_composite, nms3, raw_score_map,
    )
    from orbslam3_tpu_torch.ops.orientation import ic_angles
    from orbslam3_tpu_torch.ops.pyramid import build_pyramid, gaussian_blur7_u8
    from orbslam3_tpu_torch.ops.select import candidate_pools, select_topk_grid_multi
    from orbslam3_tpu_torch.oracle.orb_cpu import FAST_BORDER, PyramidParams

    dev = torch.device(device)
    params = PyramidParams(n_features=1000)
    rng = np.random.default_rng(0)
    img_np = rng.integers(0, 256, (h, w), np.uint8)
    img = torch.from_numpy(img_np).to(dev)
    pair = torch.from_numpy(np.stack([img_np, rng.integers(0, 256, (h, w), np.uint8)])).to(dev)
    # the stages read their constant tables from the modules, as the frame
    # programs do: nothing is uploaded inside a timed (captured) call
    x = FeatureExtractor.from_reference(params, (h, w)).to(dev)
    fe = StereoFrontEnd.from_reference(params, (h, w), DEFAULT_MBF, DEFAULT_FX).to(dev)
    taps = x.resize_taps()
    out = {}

    def want(name):
        return not only or name in only

    def report(name, fn):
        out[name] = per_call_ms(fn, dev, calls)
        print(f"{name:8s}: {out[name]:.3f} ms", flush=True)

    b = FAST_BORDER
    pyr = build_pyramid(img, params, taps)
    active, crops = detection_crops(pyr, params)
    if want("pyramid"):
        report("pyramid", lambda: build_pyramid(img, params, taps))
    if want("blur"):
        report("blur x8", lambda: [gaussian_blur7_u8(l, taps=x.blur_taps) for l in pyr])
    if want("fast"):
        report("fast", lambda: detect_two_threshold_multi(
            crops, params.ini_th_fast, params.min_th_fast, mask=x.det_mask))
    if want("fastraw"):
        comp, _, _ = detection_composite(crops)
        print(f"  comp shape: {tuple(comp.shape)}", flush=True)
        report("fastraw", lambda: raw_score_map(comp, x.det_mask))
        raw = raw_score_map(comp, x.det_mask)
        report("fastnms", lambda: nms3(raw))
    scores = detect_two_threshold_multi(crops, params.ini_th_fast, params.min_th_fast,
                                        mask=x.det_mask)
    quotas = [int(q) for q in params.features_per_level()]
    quotas = [quotas[l] for l in active]
    if want("select"):
        report("select", lambda: select_topk_grid_multi(scores, quotas))
    if want("pool"):
        report("pool", lambda: candidate_pools(scores, quotas))
    sels = select_topk_grid_multi(scores, quotas)
    levels = [pyr[l] for l in active]
    xys = [torch.where(v[:, None], xy + b, b + 3) for (xy, _, v) in sels]
    if want("orient"):
        report("orient", lambda: [ic_angles(l, xy, weights=x.ic_weights)
                                  for l, xy in zip(levels, xys)])
    if want("brief"):
        angs = [ic_angles(l, xy, weights=x.ic_weights) for l, xy in zip(levels, xys)]
        samps = [brief_sampling_image(l, gaussian_blur7_u8(l, taps=x.blur_taps)) for l in levels]
        report("brief", lambda: [
            brief_descriptors(s, xy.to(torch.float32), a, pattern=x.brief_pattern)
            for s, xy, a in zip(samps, xys, angs)])
    if want("mono"):
        report("mono", lambda: x.eager(img))
    if want("stereo"):
        report("stereo", lambda: fe.eager(pair))
    if want("stereoparts"):
        from orbslam3_tpu_torch.frontend.stereo_frame import sad_refine, sad_strips, stereo_pairs

        feat_l, feat_r = fe.extract(pair)
        max_d = DEFAULT_MBF / (DEFAULT_MBF / DEFAULT_FX)
        pair_args = (feat_l, feat_r, fe.level_hw, fe.scale_factors, fe.inv_scale_factors,
                     (fe.row_off[0], fe.col_off[0]), (fe.row_off[1], fe.col_off[1]), max_d)
        pairs = stereo_pairs(*pair_args)
        comp = build_merged_composites(
            [build_pyramid(pair[i], params, taps) for i in range(2)], fe).bordered
        sad_args = (*sad_strips(comp, comp, pairs), pairs, feat_l.xy, feat_l.octave,
                    fe.scale_factors, max_d, DEFAULT_MBF)

        def detect():
            pyr_l = build_pyramid(pair[0], params, taps)
            pyr_r = build_pyramid(pair[1], params, taps)
            _, crops_l = detection_crops(pyr_l, params)
            _, crops_r = detection_crops(pyr_r, params)
            return detect_two_threshold_multi(crops_l + crops_r, params.ini_th_fast,
                                              params.min_th_fast, mask=fe.det_mask)

        report("s:detect", detect)
        report("s:feats", lambda: fe.extract(pair))
        report("s:pairs", lambda: stereo_pairs(*pair_args))
        report("s:sad", lambda: sad_refine(*sad_args))
    return out


def main(argv=None) -> int:
    from orbslam3_tpu_torch.tools.card import open_device

    argv = sys.argv[1:] if argv is None else argv
    device = next((a.split("=", 1)[1] for a in argv if a.startswith("--device=")), "cuda")
    calls = int(next((a.split("=", 1)[1] for a in argv if a.startswith("--calls=")), 20))
    only = {a for a in argv if not a.startswith("--")}
    unknown = only - set(STAGES)
    if unknown:
        print(f"bench_stages: unknown stages {sorted(unknown)}; stages: {', '.join(STAGES)}",
              file=sys.stderr)
        return 2
    if open_device("bench_stages", device) is None:
        return 1
    run(only, device, calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
