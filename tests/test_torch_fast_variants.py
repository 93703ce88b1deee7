"""T1-T4: the port's FAST-score variants against the Pallas functions of the
A/B harnesses under tools/.

Each TPU function runs under `pltpu.force_tpu_interpret_mode()` on seeded
small images (odd sizes included) at its default case and its parameter
corners; the port's plain version must equal the `[:h, :w]` crop bit for
bit, borders included (the TPU functions score the zero-padded image).  On
the CPU the wrappers take the plain versions and launch nothing.  The
harness modules set JAX's compilation-cache directory when imported; it is
restored after loading them.

The kernel (``csrc/fast_variants.cu``) forms no ring difference: it
reduces the raw ring values of the zero-padded image to A (max over the
16 circular 9-arcs of the arc's min) and B (min over them of the arc's
max) in the variant's form, and folds score - 1 = max(A - c, c - B) - 1,
as max(A + 255 - c, c + 255 - B) - 256 in unsigned 16-bit lanes where the
variant is packed.  `folded_score` below is that arithmetic in plain
torch, held against `score_plain` and the TPU function for every
instantiation (reducer x passes x lane width) on the images that take the
score to both ends of its range (tools/score_extremes.py).
"""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from orbslam3_tpu_torch.ops import fast_variants as fv
from orbslam3_tpu_torch.oracle.orb_cpu import FAST_RING
from orbslam3_tpu_torch.tools import score_extremes as se

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(37, 150), (70, 201)]


def _load_harnesses() -> dict:
    saved = {
        k: getattr(jax.config, k)
        for k in ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    }
    mods = {}
    try:
        for tag, name in (("t1", "bench_fast_variants"), ("t2", "bench_fast_variants2"),
                          ("t3", "bench_fast_variants3"), ("t4", "bench_fast_variants4")):
            spec = importlib.util.spec_from_file_location(
                f"_tpu_{name}", os.path.join(REPO, "tools", f"{name}.py")
            )
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods[tag] = mod
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mods


@pytest.fixture(scope="module")
def tpu():
    return _load_harnesses()


_JNP = {None: None, torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16}

# (function, wrapper arguments after the image): each function's default
# case first, then its parameter corners
CASES = [
    ("t1", (False, None, None)),
    ("t1", (True, None, None)),
    ("t1", (False, None, torch.int32)),
    ("t1", (False, torch.bfloat16, torch.int32)),
    ("t1", (True, None, torch.bfloat16)),
    ("t2", (32,)),
    ("t2", (16, fv.VANHERK)),
    ("t2", (16, fv.LOGSTEP, (8, 128))),
    ("t2", (32, fv.VANHERK, (16, 256))),
    ("t3", (48, 384, "twopass")),
    ("t3", (16, 128, "onepass")),
    ("t3", (8, 256, "twopass")),
    ("t4", (48, 384, fv.VANHERK)),
    ("t4", (16, 128, fv.PAIRS)),
    ("t4", (32, 256, fv.PAIRS)),
]


def _tpu_function(tpu, fn: str, args: tuple):
    """The Pallas function for the port's `args`."""
    if fn == "t1":
        cast_early, chain, in_dtype = args
        return tpu["t1"].make_variant(cast_early, _JNP[chain], _JNP[in_dtype])
    if fn == "t2":
        return tpu["t2"].make_prod_like(*args)
    if fn == "t3":
        return tpu["t3"].make_kernel(*args)
    strip, chunk, win = args
    mod = tpu["t4"]
    return mod.make_kernel(strip, chunk, mod._win9 if win == fv.VANHERK else mod._win9_pairs)


PLAIN = {
    "t1": fv.fast_variant_t1_plain, "t2": fv.fast_variant_t2_plain,
    "t3": fv.fast_variant_t3_plain, "t4": fv.fast_variant_t4_plain,
}
WRAPPER = {
    "t1": fv.fast_variant_t1, "t2": fv.fast_variant_t2,
    "t3": fv.fast_variant_t3, "t4": fv.fast_variant_t4,
}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fn,args", CASES, ids=[f"{f}-{i}" for i, (f, _) in enumerate(CASES)])
def test_plain_equals_pallas_crop(tpu, fn, args, shape):
    img = np.random.default_rng(shape[0] * 1000 + shape[1]).integers(0, 256, shape, np.uint8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_tpu_function(tpu, fn, args)(jnp.asarray(img)))
    h, w = shape
    got = PLAIN[fn](torch.from_numpy(img), *args)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want[:h, :w])


def test_cpu_wrappers_take_the_plain_versions():
    img = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (41, 77), np.uint8))
    before = {fn: w.launches for fn, w in WRAPPER.items()}
    ref = fv.fast_variant_t1_plain(img, False)
    for fn, args in CASES:
        got = WRAPPER[fn](img, *args)
        assert torch.equal(got, PLAIN[fn](img, *args))
        assert torch.equal(got, ref)  # one function, every variant
    assert {fn: w.launches for fn, w in WRAPPER.items()} == before == {fn: 0 for fn in WRAPPER}


def test_plain_version_is_the_zero_padded_fast_score():
    """The numpy FAST score of the zero-padded image, minus 1, at every
    pixel: max over the 16 circular 9-arcs of min(d), of min(-d)."""
    from orbslam3_tpu_torch.oracle.orb_cpu import FAST_RING

    img = np.random.default_rng(9).integers(0, 256, (23, 31), np.uint8)
    h, w = img.shape
    pad = np.pad(img.astype(np.int32), 3)
    d = np.stack([pad[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dx, dy in FAST_RING])
    d = d - img.astype(np.int32)[None]
    arcs = np.stack([np.roll(d, -o, axis=0)[:9] for o in range(16)])  # (16, 9, h, w)
    want = np.maximum(arcs.min(1).max(0), (-arcs).min(1).max(0)) - 1
    got = fv.fast_variant_t3(torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_check_their_arguments():
    img = torch.zeros((16, 16), dtype=torch.uint8)
    with pytest.raises(TypeError):
        fv.fast_variant_t3(img.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        fv.fast_variant_t3(torch.zeros((16, 32), dtype=torch.uint8)[:, ::2])
    with pytest.raises(ValueError, match="shared memory"):
        fv.fast_variant_t3(img, 64, 2048)  # a 287,840 B halo, over the 232,448 B an H100 block opts in to
    with pytest.raises(ValueError, match="mode"):
        fv.fast_variant_t3(img, mode="threepass")
    with pytest.raises(ValueError, match="arc"):
        fv.fast_variant_t2(img, 32, "pairs")
    with pytest.raises(ValueError, match="dtypes"):
        fv.fast_variant_t1(img, False, torch.float16)


def _block8_vanherk(p: list, op) -> list:
    """B1's van Herk form (fast_score.cuh arc_reduce): window o < 8 is
    suffix o of block 0 with prefix o of block 1, window 8 + o suffix o of
    block 1 with prefix o of block 0."""
    def scans(b):
        pf = [b[0]]
        for k in range(1, 8):
            pf.append(op(pf[-1], b[k]))
        sf = [None] * 8
        sf[7] = b[7]
        for k in range(6, 0, -1):
            sf[k] = op(sf[k + 1], b[k])
        sf[0] = pf[7]
        return pf, sf

    pf0, sf0 = scans(p[:8])
    pf1, sf1 = scans(p[8:])
    return [op(sf0[o], pf1[o]) for o in range(8)] + [op(sf1[o], pf0[o]) for o in range(8)]


def _logstep(p: list, op) -> list:
    """arc_reduce_logstep of fast_score.cuh: circular windows of 2, 4, 8,
    then the ninth value."""
    m2 = [op(p[o], p[(o + 1) % 16]) for o in range(16)]
    m4 = [op(m2[o], m2[(o + 2) % 16]) for o in range(16)]
    m8 = [op(m4[o], m4[(o + 4) % 16]) for o in range(16)]
    return [op(m8[o], p[(o + 8) % 16]) for o in range(16)]


_WINDOWS = {fv.LOGSTEP: _logstep, fv.VANHERK: _block8_vanherk, fv.PAIRS: fv._win9_pairs}


def folded_score(img: torch.Tensor, variant: fv.Variant) -> torch.Tensor:
    """The kernel's arithmetic for `variant` in plain torch: (h, w) int32."""
    h, w = img.shape

    def ring():
        pad = torch.nn.functional.pad(img.to(torch.int32), (3, 3, 3, 3))
        return [pad[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dx, dy in FAST_RING.tolist()]

    c = img.to(torch.int32)
    windows = _WINDOWS[variant.reducer]
    # two passes load the ring values again for B: the same values
    a = torch.stack(windows(ring(), torch.minimum)).amax(0)
    b = torch.stack(windows(ring(), torch.maximum)).amin(0)
    if not variant.packed:
        return torch.maximum(a - c, c - b) - 1
    biased = torch.maximum(a + 255 - c, c + 255 - b)
    assert int(biased.min()) >= 0 and int(biased.max()) <= 510  # fits an unsigned 16-bit lane
    return biased - 256


# each instantiation of the kernel, by a TPU case that maps to it
INSTANTIATIONS = [
    ("t1", (False, None, None)),           # log-step, one pass, int32 lanes
    ("t2", (32,)),                         # log-step, one pass, u16 lanes
    ("t4", (48, 384, fv.VANHERK)),         # van Herk, one pass
    ("t3", (48, 384, "twopass")),          # van Herk, two passes
    ("t4", (16, 128, fv.PAIRS)),           # pairs, one pass
]
SCORE_IMAGES = se.score_images()


@pytest.mark.parametrize("name", sorted(SCORE_IMAGES))
@pytest.mark.parametrize("fn,args", INSTANTIATIONS,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(INSTANTIATIONS)])
def test_folded_algebra_equals_plain_and_pallas(tpu, fn, args, name):
    img = SCORE_IMAGES[name]
    variant = {"t1": fv.t1_variant, "t2": fv.t2_variant, "t3": fv.t3_variant,
               "t4": fv.t4_variant}[fn](*args)
    got = folded_score(torch.from_numpy(img), variant)
    np.testing.assert_array_equal(got.numpy(), PLAIN[fn](torch.from_numpy(img), *args).numpy())
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_tpu_function(tpu, fn, args)(jnp.asarray(img)))
    h, w = img.shape
    np.testing.assert_array_equal(got.numpy(), want[:h, :w])


def test_instantiations_cover_every_kernel_form():
    forms = {(v.reducer, v.passes, v.packed) for v in (
        {"t1": fv.t1_variant, "t2": fv.t2_variant, "t3": fv.t3_variant, "t4": fv.t4_variant}[f](*a)
        for f, a in INSTANTIATIONS)}
    assert forms == {(fv.LOGSTEP, 1, False), (fv.LOGSTEP, 1, True), (fv.VANHERK, 1, True),
                     (fv.VANHERK, 2, True), (fv.PAIRS, 1, True)}


def test_halo_bytes_and_the_tiles_above_48_kb():
    """The u16 halo of T3's s64 c384 and s48 c768 tiles needs more than the
    48 KB a block gets without opting in; every harness case fits the
    232,448 B an H100 block can opt in to, and a cols % 4 == 2 tile rounds
    its groups up."""
    from orbslam3_tpu_torch.tools.bench_fast_variants import CASES, FUNCTIONS

    assert fv.halo_bytes(64, 384) == 70 * 392 * 2 == 54880
    assert fv.halo_bytes(48, 768) == 54 * 776 * 2 == 83808
    assert fv.halo_bytes(8, 130) == fv.halo_bytes(8, 132) == 14 * 140 * 2
    sizes = {(fn, label): fv.halo_bytes(FUNCTIONS[fn][2](*args).rows, FUNCTIONS[fn][2](*args).cols)
             for fn, cases in CASES.items() for label, args in cases}
    assert max(sizes.values()) <= fv.MAX_TILE_BYTES == 232448
    assert {k for k, b in sizes.items() if b > 48 * 1024} == {
        ("t3", "twopass s48 c768"), ("t3", "twopass s64 c384"), ("t4", "pairs s48 c768")}


def test_harness_check_pass_and_bound_on_cpu():
    """The port's A/B harness on a CPU image: its check pass runs every case
    of the four TPU harnesses through the wrappers (the plain versions
    here, so no launch); the bound is the function's, the same for every
    case: 118 ops/px in 16-bit lanes at 2112x736."""
    from orbslam3_tpu_torch.tools import bench_fast_variants as bfv
    from orbslam3_tpu_torch.utils import device_time as dt

    img = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (37, 53), np.uint8))
    results = bfv.check({"odd": img}, log=lambda _: None)
    assert len(results) == sum(map(len, bfv.CASES.values()))
    assert all(r["max_abs_err"] == 0 for r in results)
    assert {fn: w.launches for fn, w in WRAPPER.items()} == {fn: 0 for fn in WRAPPER}
    assert dt.FAST_SCORE_OPS_PER_PX == 118
    n = 2112 * 736
    ms, bound_by = bfv.score_bound_ms((2112, 736))
    assert bound_by == "operations"
    assert ms == pytest.approx(n * 118 / dt.INT16X2_OPS_PER_S * 1e3, rel=1e-12)


@pytest.mark.cuda
def test_kernels_equal_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the T1-T4 kernels have no CPU form")
    from orbslam3_tpu_torch.tools.bench_fast_variants import CASES as HARNESS_CASES, FUNCTIONS

    img = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (333, 517), np.uint8)
    ).cuda()
    big = []
    for fn, cases in HARNESS_CASES.items():
        wrapper, plain, mapping = FUNCTIONS[fn]
        for _, args in cases:
            assert torch.equal(wrapper(img, *args), plain(img, *args))
            v = mapping(*args)
            big += [args] if fv.halo_bytes(v.rows, v.cols) > 48 * 1024 else []
    assert len(big) == 3  # T3 s48 c768 and s64 c384, T4 s48 c768: opted in above 48 KB
    # a tile whose halo needs 144,480 B, and one with cols % 4 == 2
    for args in ((64, 1024, "twopass"), (7, 258, "onepass")):
        assert torch.equal(fv.fast_variant_t3(img, *args), fv.fast_variant_t3_plain(img, *args))
