"""Check and time the window kernels B2, B4 and B5 on the card.

    python -m orbslam3_tpu_torch.tools.bench_window_kernels [--reps N]

Builds the kernels of the tree it is run from and holds B2
(``window_gather.gather_windows_many`` / ``gather_windows``), B4
(``window_gather.window_moments(fused=True)``) and both modes of B5 (the
index mode ``window_gather.sample_windows(fused=True)``, the rBRIEF mode
``brief.brief_descriptors(fused=True)``) bit for bit against their plain
versions: at the main path's shapes (752x480 synthetic stereo pair, 8
levels: the 3454x760 merged composite of both cameras, 1762x760 of one)
and at the edge cases of `b2_edge_errs`, `b4_edge_errs`, `b5_edge_errs`
and `brief_edge_errs` (windows that touch an image's first and last byte
when h*w % 4 != 0, images that are views 1-3 bytes past an aligned base,
K = 1 and K not a multiple of a block's windows, windows under 4 columns,
the TPU kernel's largest 48x128 window, windows too large for one block,
two jobs of different shapes in one launch, index planes that are not
16-byte aligned, keypoints on half-pixel positions and off the image) and
of `b2_grid_mix_err` (two jobs whose grids differ by 2^20 blocks).  The
rBRIEF mode is held, with (cos, sin) pinned, against the default
composition (`brief_descriptors` over a B2 window gather), which both
this tree and its parent have.  Then it times, N times each (device time
of a CUDA graph of 20 calls, ``utils/device_time.device_ms``): B2 as a
stereo frame launches it (the orientation + BRIEF pair at K=2000 and the
SAD pair at K=1000), each pair alone and each of the four shapes alone; B4
at K=1000, 2000 and 5000 on the mono composite; B5's index mode at K=1000
and 5000 on the mono sampling composite; the whole
``brief_descriptors(fused=True)`` call (angles in degrees, trig in the
call) at K=1000 and 5000, and the default composition at K=1000; and the
launch floor (one in-place add on one element).

Every function it calls exists in the tree before the rBRIEF mode, so one
run of this tool from each tree, on the same card, alternating (parent,
change, change, parent), is an A/B (copy the tool into the parent tree).
The last line is a JSON object; ``exact`` lists every check.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

H, W, FX, BASELINE, SEED = 480, 752, 435.2, 0.11, 1
# the main path's B2 jobs of one stereo frame: (label, image, window, K)
PATH_PAIRS = {
    "orient+brief": (("bordered", 31, 31), ("sampling", 37, 37)),
    "sad": (("bordered", 11, 11), ("bordered", 11, 21)),
}
PATH_K = {"orient+brief": 2000, "sad": 1000}


def _err(got, want) -> float:
    if isinstance(got, (tuple, list)):
        return max(_err(g, w) for g, w in zip(got, want))
    if got.is_cuda:
        torch.cuda.synchronize()
    return float((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def starts(rng, h, w, nr, nc, k, dev):
    """(row0, col0) int32 on `dev`: uniform starts, the first six on the
    image's corners and out of bounds on every side (clamped in-kernel)."""
    r = rng.integers(0, h - nr + 1, k).astype(np.int32)
    c = rng.integers(0, w - nc + 1, k).astype(np.int32)
    edge_r = [h - nr, 0, -9, h, 3 * h, 0]
    edge_c = [w - nc, 0, w + 5, -1, 0, -10 * w]
    r[: min(6, k)], c[: min(6, k)] = edge_r[:k], edge_c[:k]
    return torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev)


def path_jobs(images: dict, seed: int = SEED) -> dict:
    """{pair: [job, job]} of the main path's B2 shapes over `images`
    ("bordered", "sampling": the stereo merged composites on the card),
    with starts from `seed`."""
    rng = np.random.default_rng(seed)
    out = {}
    for pair, jobs in PATH_PAIRS.items():
        k = PATH_K[pair]
        out[pair] = []
        for name, nr, nc in jobs:
            img = images[name]
            out[pair].append((img, *starts(rng, *img.shape, nr, nc, k, img.device), nr, nc))
    return out


def _edge_images(dev, seed: int) -> dict:
    """Images whose size and base address leave words partly outside them:
    97x211 (h*w % 4 == 3) and views of it 1-3 bytes past an aligned base."""
    rng = np.random.default_rng(seed)
    h, w = 97, 211
    buf = torch.from_numpy(rng.integers(0, 256, h * w + 64, dtype=np.uint8)).to(dev)
    imgs = {"97x211": torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(dev)}
    for off in (1, 2, 3):
        imgs[f"97x211 view +{off}"] = buf[off : off + h * w].view(h, w)
    return imgs


def b2_edge_errs(dev, seed: int = SEED) -> dict:
    """{case: max abs err} of B2 against its plain version at the edge
    cases; each case is one launch of one or two jobs."""
    from orbslam3_tpu_torch.ops import window_gather as wg

    rng = np.random.default_rng(seed + 100)
    imgs = _edge_images(dev, seed)
    # the path's shapes, the TPU kernel's largest, and windows under 4
    # columns (a thread's word then spans several rows and windows)
    shapes = ((31, 31), (37, 37), (11, 11), (11, 21), (48, 128), (1, 1), (3, 2), (5, 3))
    cases = {}
    for name, img in imgs.items():
        for nr, nc in shapes:
            for k in (1, 17, 2001):
                cases[f"{name} {nr}x{nc} K={k}"] = [(img, *starts(rng, *img.shape, nr, nc, k, dev), nr, nc)]
    # windows too large for one block: a block takes rows, or part of a row
    big = torch.from_numpy(rng.integers(0, 256, (480, 753), dtype=np.uint8)).to(dev)
    wide = torch.from_numpy(rng.integers(0, 256, (3, 30001), dtype=np.uint8)).to(dev)
    cases["480x753 200x300 K=5"] = [(big, *starts(rng, 480, 753, 200, 300, 5, dev), 200, 300)]
    cases["3x30001 2x30000 K=3"] = [(wide, *starts(rng, 3, 30001, 2, 30000, 3, dev), 2, 30000)]
    # two jobs of different shapes and images in one launch
    a, b = imgs["97x211"], imgs["97x211 view +1"]
    for k in (1, 33):
        cases[f"two jobs 31x31 + 48x128 K={k}"] = [
            (a, *starts(rng, *a.shape, 31, 31, k, dev), 31, 31),
            (b, *starts(rng, *b.shape, 48, 128, k, dev), 48, 128),
        ]
        cases[f"two jobs 37x37 + 11x21 K={k}"] = [
            (b, *starts(rng, *b.shape, 37, 37, k, dev), 37, 37),
            (big, *starts(rng, 480, 753, 11, 21, k, dev), 11, 21),
        ]
    return {label: _err(wg.gather_windows_many(jobs), [wg.gather_windows_plain(*job) for job in jobs])
            for label, jobs in cases.items()}


def b2_grid_mix_err(dev, seed: int = SEED) -> float:
    """Max abs err of B2 against its plain version at one launch of two jobs
    whose grids differ by far: K = 2^20 windows of 48x23 (one output word a
    thread, more than 2^30 output bytes, so grid.x >= 2^20) beside 1x24
    windows (two words a thread, so most of the launch's blocks lie past
    that job's own).  Needs ~1.2 GB of output; the large job is compared in
    slices of 2^16 windows."""
    from orbslam3_tpu_torch.ops import window_gather as wg

    rng = np.random.default_rng(seed + 400)
    k = 2**20
    img = _edge_images(dev, seed)["97x211 view +1"]
    jobs = [(img, *starts(rng, *img.shape, nr, nc, k, dev), nr, nc) for nr, nc in ((48, 23), (1, 24))]
    big, small = wg.gather_windows_many(jobs)
    err = _err(small, wg.gather_windows_plain(*jobs[1]))
    _, r, c, nr, nc = jobs[0]
    step = 2**16
    for k0 in range(0, k, step):
        want = wg.gather_windows_plain(img, r[k0 : k0 + step], c[k0 : k0 + step], nr, nc)
        err = max(err, _err(big[k0 : k0 + step], want))
    return err


def covered_bytes(jobs) -> int:
    """Distinct image bytes that the windows of `jobs` ((img2d, row0, col0,
    nr, nc), starts clamped as the kernels clamp them) cover, an image that
    several jobs read counted once: the least a gather of these windows must
    read.  Counted on the images' device with a 2-D difference array."""
    marks = {}
    for img, r, c, nr, nc in jobs:
        h, w = img.shape
        d = marks.setdefault(
            (img.data_ptr(), h, w), torch.zeros((h + 1, w + 1), dtype=torch.int32, device=img.device))
        r = r.long().clamp(0, h - nr)
        c = c.long().clamp(0, w - nc)
        one = torch.ones(r.shape, dtype=torch.int32, device=img.device)
        for rr, cc, sign in ((r, c, 1), (r + nr, c, -1), (r, c + nc, -1), (r + nr, c + nc, 1)):
            d.index_put_((rr, cc), sign * one, accumulate=True)
    return sum(int((d.cumsum(0).cumsum(1)[:-1, :-1] > 0).sum()) for d in marks.values())


def picked_bytes(img, row0, col0, ridx, cidx, nr: int, nc: int) -> int:
    """Distinct image bytes that B5's picks read (starts clamped): the least
    a sampling of these windows must read."""
    h, w = img.shape
    rr = row0.long().clamp(0, h - nr)[:, None] + ridx.long()
    cc = col0.long().clamp(0, w - nc)[:, None] + cidx.long()
    seen = torch.zeros(h * w, dtype=torch.bool, device=img.device)
    seen[(rr * w + cc).reshape(-1)] = True
    return int(seen.sum())


def b4_edge_errs(dev, seed: int = SEED) -> dict:
    """{case: max abs err} of B4 against its plain version at the edge
    cases: the 31x31 IC windows (the compiled-in shape) and other shapes
    (the run-time instantiation) up to 48x128, the most the wrapper takes."""
    from orbslam3_tpu_torch.ops import window_gather as wg
    from orbslam3_tpu_torch.ops.orientation import ic_weights

    rng = np.random.default_rng(seed + 200)
    imgs = _edge_images(dev, seed)
    weights = {(31, 31): ic_weights(dev)}
    for nr, nc in ((37, 37), (17, 45), (1, 1), (48, 128)):
        weights[(nr, nc)] = torch.from_numpy(
            rng.integers(-15, 16, (2, nr, nc)).astype(np.int32)).to(dev)
    errs = {}
    for name, img in imgs.items():
        for (nr, nc), wts in weights.items():
            for k in (1, 9, 1001):
                r, c = starts(rng, *img.shape, nr, nc, k, dev)
                errs[f"{name} {nr}x{nc} K={k}"] = _err(
                    wg.window_moments(img, r, c, wts, fused=True),
                    wg.window_moments_plain(img, r, c, wts))
    return errs


def b5_edge_errs(dev, seed: int = SEED) -> dict:
    """{case: max abs err} of B5's index mode against its plain version at
    the edge cases: the BRIEF sampling (37x37, 512 samples) and other
    shapes and sample counts (16-byte index loads where S % 16 == 0, the
    scalar form otherwise), and index planes 4 bytes past an aligned base
    (the scalar form)."""
    from orbslam3_tpu_torch.ops import window_gather as wg

    rng = np.random.default_rng(seed + 500)
    errs = {}
    for name, img in _edge_images(dev, seed).items():
        for nr, nc, s in ((37, 37, 512), (11, 21, 128), (11, 21, 100), (1, 1, 16), (48, 128, 1024)):
            for k in (1, 9, 1001):
                r, c = starts(rng, *img.shape, nr, nc, k, dev)
                ri = torch.from_numpy(rng.integers(0, nr, (k, s)).astype(np.int32)).to(dev)
                ci = torch.from_numpy(rng.integers(0, nc, (k, s)).astype(np.int32)).to(dev)
                want = wg.sample_windows_plain(img, r, c, ri, ci, nr, nc)
                errs[f"{name} {nr}x{nc} S={s} K={k}"] = _err(
                    wg.sample_windows(img, r, c, ri, ci, nr, nc, fused=True), want)
                if k == 9:
                    buf = torch.empty(k * s + 1, dtype=torch.int32, device=dev)
                    buf[1:] = ri.reshape(-1)
                    errs[f"{name} {nr}x{nc} S={s} K={k} ridx +4 B"] = _err(
                        wg.sample_windows(img, r, c, buf[1:].view(k, s), ci, nr, nc, fused=True), want)
    return errs


def brief_inputs(rng, h: int, w: int, k: int, dev) -> tuple:
    """(xy, angles, (cos, sin)) of K keypoints whose BRIEF windows lie in,
    or up to 3 px off, an (h, w) sampling image: f32 level coordinates, a
    third of them on half pixels (rounded half to even), the first six far
    off the image's sides (clamped); angles in degrees, and their (cos, sin)
    from float64."""
    # a window starts at rint(xy) + BRIEF_PAD - PATCH_HALF = rint(xy) + 1
    xy = np.stack([rng.uniform(-4, w - 36 + 3, k), rng.uniform(-4, h - 36 + 3, k)], 1)
    xy = xy.astype(np.float32)
    xy[: k // 3] = np.floor(xy[: k // 3]) + 0.5
    edge = [(-9, 5), (w + 5, 5), (5, -9), (5, h + 5), (-40, h + 40), (w + 40, -40)]
    xy[: min(6, k)] = np.asarray(edge[: min(6, k)], np.float32)
    ang = rng.uniform(0, 360, k).astype(np.float32)
    rad = ang.astype(np.float64) * np.pi / 180.0
    cos, sin = np.cos(rad).astype(np.float32), np.sin(rad).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (xy, ang)) + (
        (torch.from_numpy(cos).to(dev), torch.from_numpy(sin).to(dev)),)


def brief_edge_errs(dev, seed: int = SEED) -> dict:
    """{case: number of descriptors that differ} of B5's rBRIEF mode, (cos,
    sin) pinned, against the default composition (a B2 window gather, then
    the rotation, picks and pack in PyTorch) on the edge images, K = 1, 9
    and 1001."""
    from orbslam3_tpu_torch.ops import brief as tb

    rng = np.random.default_rng(seed + 600)
    errs = {}
    for name, img in _edge_images(dev, seed).items():
        pattern = tb.brief_pattern(dev)
        for k in (1, 9, 1001):
            xy, ang, trig = brief_inputs(rng, *img.shape, k, dev)
            got = tb.brief_descriptors(img, xy, ang, trig, pattern, fused=True)
            want = tb.brief_descriptors(img, xy, ang, trig, pattern)
            errs[f"{name} K={k}"] = float((got != want).any(1).sum().item())
    return errs


def launch_floor_ms() -> float:
    """Device time per call of one in-place add on one element: the fixed
    cost of a launch in the CUDA-graph harness of `device_ms`."""
    from orbslam3_tpu_torch.utils.device_time import device_ms

    x = torch.zeros(1, device="cuda")
    return device_ms(lambda: x.add_(1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2, help="timings of each case")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_window_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    import orbslam3_tpu_torch as port
    from orbslam3_tpu_torch import _build
    from orbslam3_tpu_torch.frontend import stereo_frame as sf
    from orbslam3_tpu_torch.ops import brief as tb, extractor as ex, pyramid, window_gather as wg
    from orbslam3_tpu_torch.utils.device_time import device_ms

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.kernels()
    build_s = time.perf_counter() - t0
    camera = port.Pinhole([FX, FX, W / 2, H / 2])
    frames = port.stereo_sequence(1, camera, BASELINE, H, W, seed=SEED)
    params = port.PyramidParams()
    fe = sf.front_end(params, (H, W), FX * BASELINE, FX, "cuda")
    pair = torch.from_numpy(np.stack(frames[0][:2])).to(dev)
    pyrs = [pyramid.build_pyramid(pair[i], params, fe.resize_taps()) for i in range(2)]
    comps = ex.build_merged_composites(pyrs, fe)
    fe_mono = ex.feature_extractor(params, (H, W), port.FusedKernels(), "cuda")
    mono_comps = ex.build_merged_composites(
        [pyramid.build_pyramid(pair[0], params, fe_mono.resize_taps())], fe_mono)
    mono, mono_sampling = mono_comps.bordered, mono_comps.sampling
    many = wg.gather_windows_many
    jobs = path_jobs({"bordered": comps.bordered, "sampling": comps.sampling})

    errs = {f"B2 path {p}": _err(many(j), [wg.gather_windows_plain(*x) for x in j])
            for p, j in jobs.items()}
    errs.update({f"B2 {k}": e for k, e in b2_edge_errs(dev).items()})
    errs["B2 grid mix 48x23 + 1x24 K=2^20"] = b2_grid_mix_err(dev)
    rng = np.random.default_rng(SEED + 300)
    b4_starts = {k: starts(rng, *mono.shape, 31, 31, k, dev) for k in (1000, 2000, 5000)}
    for k, (r, c) in b4_starts.items():
        errs[f"B4 mono composite K={k}"] = _err(
            wg.window_moments(mono, r, c, fe_mono.ic_weights, fused=True),
            wg.window_moments_plain(mono, r, c, fe_mono.ic_weights))
    errs.update({f"B4 {k}": e for k, e in b4_edge_errs(dev).items()})
    rng = np.random.default_rng(SEED + 700)
    b5_in, brief_in = {}, {}
    pattern = fe_mono.brief_pattern
    for k in (1000, 5000):
        r, c = starts(rng, *mono_sampling.shape, 37, 37, k, dev)
        ri, ci = (torch.from_numpy(rng.integers(0, 37, (k, 512)).astype(np.int32)).to(dev)
                  for _ in range(2))
        b5_in[k] = (mono_sampling, r, c, ri, ci, 37, 37)
        errs[f"B5 index mono sampling K={k}"] = _err(
            wg.sample_windows(*b5_in[k], fused=True), wg.sample_windows_plain(*b5_in[k]))
        xy, ang, trig = brief_in[k] = brief_inputs(rng, *mono_sampling.shape, k, dev)
        errs[f"B5 rBRIEF mono sampling K={k} pinned"] = _err(
            tb.brief_descriptors(mono_sampling, xy, ang, trig, pattern, fused=True),
            tb.brief_descriptors(mono_sampling, xy, ang, trig, pattern))
    errs.update({f"B5 index {k}": e for k, e in b5_edge_errs(dev).items()})
    errs.update({f"B5 rBRIEF {k}": e for k, e in brief_edge_errs(dev).items()})

    def frame():
        for j in jobs.values():
            many(j)

    timed = {"B2 frame (both pairs)": frame}
    timed.update({f"B2 pair {p}": (lambda j=j: many(j)) for p, j in jobs.items()})
    timed.update({f"B2 {nr}x{nc} K={r.shape[0]}": (lambda x=(img, r, c, nr, nc): wg.gather_windows(*x))
                  for j in jobs.values() for img, r, c, nr, nc in j})
    timed.update({f"B4 K={k}": (lambda r=r, c=c: wg.window_moments(
        mono, r, c, fe_mono.ic_weights, fused=True)) for k, (r, c) in b4_starts.items()})
    timed.update({f"B5 index K={k}": (lambda x=x: wg.sample_windows(*x, fused=True))
                  for k, x in b5_in.items()})
    timed.update({f"brief_descriptors fused K={k}": (lambda x=x: tb.brief_descriptors(
        mono_sampling, x[0], x[1], pattern=pattern, fused=True)) for k, x in brief_in.items()})
    xy, ang, _ = brief_in[1000]
    timed["brief_descriptors default K=1000"] = lambda: tb.brief_descriptors(
        mono_sampling, xy, ang, pattern=pattern)
    times = {label: [device_ms(fn) for _ in range(args.reps)] for label, fn in timed.items()}
    times["launch floor (1-element add)"] = [launch_floor_ms() for _ in range(args.reps)]
    for label, ms in times.items():
        print(f"{label} device ms: {' '.join(f'{t:.5f}' for t in ms)}")
    exact = {k: e == 0 for k, e in errs.items()}
    print(f"bit-exact: {sum(exact.values())} of {len(exact)} checks")
    print(json.dumps(dict(build_s=build_s, times=times, exact=exact)))
    return 0 if all(exact.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
