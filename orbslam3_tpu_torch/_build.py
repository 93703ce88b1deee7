"""Lazy build of the hand-written CUDA kernels under ``csrc/``.

Each ``.cu`` source compiles with ``nvcc`` for ``sm_90a`` into an object
file, all of them at once in parallel processes, and the objects link into
one shared library with a plain C interface, loaded with ``ctypes``.
Nothing is built when a module is imported: the first kernel launch calls
`kernels()`, which builds into ``_build/`` (keyed by a hash of the sources,
headers and flags, so an edited kernel rebuilds) and loads the library once
per process.  A failed build raises; no caller falls back to a plain
version.

`host_library` builds the port's C++ host libraries (``native/src``) with
g++ into the same directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build in this process reported: seconds spent in nvcc (0
# when the library was already built) and nvcc's -Xptxas -v output
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # fast_score(img, mask, out, h, w, stream)
    "fast_score": [_P, _P, _P, _I, _I, _P],
    # gather_windows(jobs, n_jobs, k, stream); jobs: n_jobs x int64
    # (img, h, w, row0, col0, nr, nc, out)
    "gather_windows": [_P, _I, _I, _P],
    # detect_fused(img, mask, sel_scratch, out, h, w, ini_th, min_th, stream)
    "detect_fused": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # window_moments(img, h, w, row0, col0, k, nr, nc, weights, out, stream)
    "window_moments": [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P],
    # sample_windows(img, h, w, row0, col0, ridx, cidx, k, s, nr, nc, out, stream)
    "sample_windows": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # brief_descriptors(img, h, w, xy, angles, cos, sin, pattern, k, factor, out, stream)
    "brief_descriptors": [_P, _I, _I, _P, _P, _P, _P, _P, _I, ctypes.c_float, _P, _P],
    # grid_pool(maps, n_maps, key, resp, ys, xs, pool, stream); maps: n_maps x
    # int64 (score, h, w, stride, cell, fine)
    "grid_pool": [_P, _I, _P, _P, _P, _P, _I, _P],
    # stereo_hamming(xy_l, oct_l, valid_l, desc_l, row_off_l, col_off_l, k_l,
    #                the same of the right camera, k_r,
    #                scale, inv_scale, level_hw, max_d, out, stream)
    "stereo_hamming": [*[_P] * 6, _I, *[_P] * 6, _I, _P, _P, _P, _F, _P, _P],
    # sad_refine(p_l, p_r, pairs, xy_l, oct_l, scale, k, max_d, mbf, th_factor,
    #            scratch, u_right, depth, stream)
    "sad_refine": [*[_P] * 6, _I, _F, _F, _F, _P, _P, _P, _P],
    # fast_variant_t1(img, out, h, w, cast_early, chain16, in_kind, stream)
    "fast_variant_t1": [_P, _P, _I, _I, _I, _I, _I, _P],
    # fast_variant_t2(img, out, h, w, strip, arc, chunk_rows, chunk_cols, stream)
    "fast_variant_t2": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    # fast_variant_t3(img, out, h, w, strip, chunk, twopass, stream)
    "fast_variant_t3": [_P, _P, _I, _I, _I, _I, _I, _P],
    # fast_variant_t4(img, out, h, w, strip, chunk, win, stream)
    "fast_variant_t4": [_P, _P, _I, _I, _I, _I, _I, _P],
}


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands as parallel processes; wait for (or kill) all."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    done = []
    try:
        for cmd, p in zip(cmds, procs):
            out, err = p.communicate(timeout=NVCC_TIMEOUT_S)
            done.append(subprocess.CompletedProcess(cmd, p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return done


def _check(procs: list[subprocess.CompletedProcess]) -> None:
    failed = [p for p in procs if p.returncode != 0]
    if failed:
        raise RuntimeError(
            "nvcc failed:\n" + "\n".join(
                f"$ {' '.join(p.args)}\n{p.stdout}\n{p.stderr}" for p in failed
            )
        )


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu = [s for s in _sources() if s.suffix == ".cu"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{s.stem}.o") for s in cu]
        compiled = _run_all(
            [[nvcc, *COMPILE_FLAGS, "-c", "-o", o, str(s)] for s, o in zip(cu, objs)]
        )
        _check(compiled)
        lib = str(Path(tmp) / so.name)
        _check(_run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]]))
        os.replace(lib, so)  # atomic: a concurrent process never loads half a file
    build_info.update(
        seconds=time.perf_counter() - t0, log="".join(p.stderr for p in compiled)
    )


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` at first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if so.exists():
                build_info.update(seconds=0.0, log="")
            else:
                _build(so)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def host_library(src: str, stem: str, suffix: str, flags) -> str | None:
    """Path of ``<stem>_<hash><suffix>`` under ``_build/``, built from the
    C++ source `src` with ``g++ <flags> src`` unless it is there already
    (the hash covers the source and the flags, so an edited source builds
    anew); None when g++ fails.  The build writes a temporary name and
    renames it, so concurrent processes never load half a file."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(Path(src).read_bytes())
    so = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}{suffix}"
    if so.exists():
        return str(so)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{stem}_", suffix=suffix)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *flags, str(src), "-o", tmp], check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return str(so)


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned a non-zero cudaGetLastError()."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
