"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them by ctypes.

The shared library is named by the sha256 of the sources, so an edited
source builds anew and an unchanged one is reused.  It goes to ``build/``
at the root of the checkout (listed in ``.gitignore``).  Nothing here runs
at import: the first CUDA launch calls :func:`library`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes; every pointer and the stream are c_void_p, so
# ctypes does not cut them to 32 bits
_SIGNATURES = {
    "branch_gemm_bf16": (_P, _P, _P, _I, _I, _I, _I, _P),
    "branch_gemm_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    "grouped_gemm_bf16": (_P, _P, _P, _P, _I, _I, _I, _P),
    "grouped_gemm_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
    "gemm_tile_m": (),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build printed (``-Xptxas -v``: registers, shared memory,
# spills per kernel) and how long it took; empty when the library was reused
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")
    return found


def _sources() -> list[pathlib.Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources unless the library for their hash exists."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            from . import TILE_M
            if lib.gemm_tile_m() != TILE_M:
                raise RuntimeError(f"csrc BM={lib.gemm_tile_m()} != "
                                   f"kernels.TILE_M={TILE_M}")
            _lib = lib
    return _lib
