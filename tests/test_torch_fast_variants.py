"""T1-T4: the port's FAST-score variants against the Pallas functions of the
A/B harnesses under tools/.

Each TPU function runs under `pltpu.force_tpu_interpret_mode()` on seeded
small images (odd sizes included) at its default case and its parameter
corners; the port's plain version must equal the `[:h, :w]` crop bit for
bit, borders included (the TPU functions score the zero-padded image).  On
the CPU the wrappers take the plain versions and launch nothing.  The
harness modules set JAX's compilation-cache directory when imported; it is
restored after loading them.
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
        fv.fast_variant_t3(img, 64, 1024)
    with pytest.raises(ValueError, match="mode"):
        fv.fast_variant_t3(img, mode="threepass")
    with pytest.raises(ValueError, match="arc"):
        fv.fast_variant_t2(img, 32, "pairs")
    with pytest.raises(ValueError, match="dtypes"):
        fv.fast_variant_t1(img, False, torch.float16)


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
    for fn, cases in HARNESS_CASES.items():
        wrapper, plain, _ = FUNCTIONS[fn]
        for _, args in cases:
            assert torch.equal(wrapper(img, *args), plain(img, *args))
