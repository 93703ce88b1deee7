"""Lazy build of the hand-written CUDA kernels under ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``.  Nothing is built when a
module is imported: the first kernel launch calls `kernels()`, which builds
into ``_build/`` (keyed by a hash of the sources and flags, so an edited
kernel rebuilds) and loads the library once per process.  A failed build
raises; no caller falls back to a plain version.
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build in this process reported: seconds spent in nvcc (0
# when the library was already built) and nvcc's -Xptxas -v output
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # fast_score(img, mask, out, h, w, stream)
    "fast_score": [_P, _P, _P, _I, _I, _P],
    # gather_windows(img, h, w, row0, col0, k, nr, nc, out, stream)
    "gather_windows": [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_info.update(seconds=time.perf_counter() - t0, log=proc.stderr)


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


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned a non-zero cudaGetLastError()."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
