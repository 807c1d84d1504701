"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them by ctypes.

Each ``*.cu`` source becomes its own shared library, named by the sha256 of
that source and of the shared headers (``*.cuh``), so an edited source builds
anew and an unchanged one is reused.  The ``nvcc`` processes of all sources
are started together and awaited together.  Libraries go to ``build/`` at
the root of the checkout (listed in ``.gitignore``).  Nothing here runs at
import: the first CUDA launch calls :func:`library`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

from .. import trace as _trace

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# entry point -> argtypes; every pointer and the stream are c_void_p, so
# ctypes does not cut them to 32 bits
_FLASH = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _F, _P)
_DECODE = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _P)
_PAGED = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
          _F, _P)
# the mma route takes the positions per block before the stream
_DECODE_MMA = _DECODE[:-1] + (_I, _P)
_PAGED_MMA = _PAGED[:-1] + (_I, _P)
_MLA = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _F,
        _P)
# the onepass route takes (threads a row, vectors a thread, SMs)
_NORM_SIMPLE = (_P, _P, _P, _I, _I, _F, _P)
_NORM = _NORM_SIMPLE[:-1] + (_I, _I, _I, _P)
# buf, gate, up, down, h, flags, out, E, C, d, f, stream; the wgmma route
# takes the SM count before the stream, the simple route has no flags
# buf, gate, up, down, h, flags, counts, out, E, C, d, f, stream
_MOE = (_P,) * 8 + (_I,) * 4 + (_P,)
_SIGNATURES = {
    "branch_gemm_bf16": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "branch_gemm_simple_bf16": (_P, _P, _P, _I, _I, _I, _I, _P),
    "branch_gemm_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    "grouped_gemm_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "grouped_gemm_simple_bf16": (_P, _P, _P, _P, _I, _I, _I, _P),
    "grouped_gemm_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
    "gemm_tile_m": (),
    "gemm_has_wgmma_tiles": (_I, _I, _I),
    "gemm_init": (),
    "rmsnorm_bf16": _NORM,
    "rmsnorm_f32": _NORM,
    "rmsnorm_simple_bf16": _NORM_SIMPLE,
    "rmsnorm_simple_f32": _NORM_SIMPLE,
    "flash_attention_bf16": _FLASH,
    "flash_attention_simple_bf16": _FLASH,
    "flash_attention_f32": _FLASH,
    "decode_attention_bf16": _DECODE_MMA,
    "decode_attention_simple_bf16": _DECODE,
    "decode_attention_f32": _DECODE,
    "paged_decode_bf16": _PAGED_MMA,
    "paged_decode_simple_bf16": _PAGED,
    "paged_decode_f32": _PAGED,
    "decode_chunk_size": (),
    "decode_tile_positions": (),
    "decode_max_splits": (),
    "mla_decode_bf16": _MLA,
    "mla_decode_f32": _MLA,
    "mla_decode_tile_positions": (),
    # the wgmma route also takes the pool's page count after the page size
    "mla_decode_wgmma_bf16": (_P,) * 7 + (_I,) * 8 + (_P, _F, _P),
    "mla_decode_wgmma_tile_positions": (),
    "mla_decode_wgmma_max_splits": (),
    "moe_mlp_bf16": _MOE[:-1] + (_I, _P),
    "moe_mlp_simple_bf16": _MOE[:5] + _MOE[6:],
    "moe_mlp_f32": _MOE,
    "moe_init": (),
    "moe_max_experts": (),
    "rwkv6_f32": (_P,) * 8 + (_I, _I, _I, _I, _P, _P),
    "rwkv6_chunked_f32": (_P,) * 9 + (_I, _I, _I, _I, _P, _P),
    "rwkv6_head_max": (),
    "rwkv6_chunk_len": (),
    # packed, a_log, d_skip, out, B, T, di, N, batch and time strides, stream
    "mamba_scan_bf16": (_P,) * 4 + (_I,) * 4 + (_L, _L, _P),
    "mamba_scan_f32": (_P,) * 4 + (_I,) * 4 + (_L, _L, _P),
    "mamba_scan_max_state": (),
}

_lock = threading.Lock()
_lib: "KernelLibrary | None" = None
# what the last build printed per source (``-Xptxas -v``: registers, shared
# memory, spills per kernel); empty when every library was reused.  The
# parallel build's time is the ``kernels.build`` span (``repro_torch.trace``)
build_log: dict[str, str] = {}


class KernelLibrary:
    """The loaded libraries; an entry point is an attribute, whichever
    source defines it."""

    def __init__(self, libs: list[ctypes.CDLL]):
        self._fns = {}
        for name, argtypes in _SIGNATURES.items():
            for lib in libs:
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                    self._fns[name] = fn
                    break
            else:
                raise RuntimeError(f"no built source defines {name}")

    def __getattr__(self, name: str):
        try:
            return self._fns[name]
        except KeyError:
            raise AttributeError(name) from None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")
    return found


def sources() -> list[pathlib.Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path(src: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256()
    for path in [src, *sorted(_CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"


def build() -> list[pathlib.Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all at once (the ``kernels.build`` span)."""
    global build_log
    outs = [library_path(src) for src in sources()]
    todo = [(src, out) for src, out in zip(sources(), outs)
            if not out.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    with _trace.span("kernels.build"):
        try:
            for src, out in todo:
                fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
                os.close(fd)
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
                running.append((src, out, tmp, cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed, log = [], {}
            for src, out, tmp, cmd, proc in running:
                text, _ = proc.communicate()
                log[src.name] = text
                if proc.returncode != 0:
                    failed.append(f"nvcc failed ({proc.returncode}):\n"
                                  f"{' '.join(cmd)}\n{text}")
                else:
                    os.replace(tmp, out)
            if failed:
                raise RuntimeError("\n".join(failed))
        finally:
            for _src, _out, tmp, _cmd, proc in running:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)
    build_log = log
    return outs


def library() -> KernelLibrary:
    """The loaded kernel libraries, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = KernelLibrary([ctypes.CDLL(str(p)) for p in build()])
            from . import (DECODE_CHUNK, DECODE_MAX_SPLITS, DECODE_TILE,
                           MAMBA_SCAN_MAX_STATE, MLA_MAX_SPLITS, MLA_TILE,
                           MLA_WGMMA_TILE, MOE_MAX_EXPERTS, RWKV6_CHUNK,
                           RWKV6_MAX_K, TILE_M)
            from .branch_gemm.kernel import WGMMA_TILES
            from .grouped_gemm.kernel import GROUPED_TILES
            if lib.gemm_tile_m() != TILE_M:
                raise RuntimeError(f"csrc TILE_M={lib.gemm_tile_m()} != "
                                   f"kernels.TILE_M={TILE_M}")
            missing = [(bm, bn, grouped) for grouped, tiles in
                       ((0, WGMMA_TILES), (1, GROUPED_TILES))
                       for bm, bn in tiles
                       if not lib.gemm_has_wgmma_tiles(bm, bn, grouped)]
            if missing:
                raise RuntimeError(f"csrc/gemm.cu compiles no wgmma tiles "
                                   f"(BM, BN, grouped) {missing}")
            err = lib.gemm_init()
            if err != 0:
                raise RuntimeError(f"gemm_init failed: CUDA error {err}")
            if lib.decode_chunk_size() != DECODE_CHUNK:
                raise RuntimeError(f"csrc DEC_CHUNK={lib.decode_chunk_size()}"
                                   f" != kernels.DECODE_CHUNK={DECODE_CHUNK}")
            if (lib.decode_tile_positions(), lib.decode_max_splits()) != (
                    DECODE_TILE, DECODE_MAX_SPLITS):
                raise RuntimeError(
                    f"csrc (DT, DM_MAX_SPLITS)=({lib.decode_tile_positions()}"
                    f", {lib.decode_max_splits()}) != kernels.(DECODE_TILE, "
                    f"DECODE_MAX_SPLITS)=({DECODE_TILE}, {DECODE_MAX_SPLITS})")
            if lib.mla_decode_tile_positions() != MLA_TILE:
                raise RuntimeError(
                    f"csrc mla_decode CH={lib.mla_decode_tile_positions()} "
                    f"!= kernels.MLA_TILE={MLA_TILE}")
            wg = (lib.mla_decode_wgmma_tile_positions(),
                  lib.mla_decode_wgmma_max_splits())
            if wg != (MLA_WGMMA_TILE, MLA_MAX_SPLITS):
                raise RuntimeError(
                    f"csrc mla_decode (BKV, MAX_SPLITS)={wg} != kernels."
                    f"(MLA_WGMMA_TILE, MLA_MAX_SPLITS)="
                    f"{(MLA_WGMMA_TILE, MLA_MAX_SPLITS)}")
            if lib.moe_max_experts() != MOE_MAX_EXPERTS:
                raise RuntimeError(
                    f"csrc moe MAX_EXPERTS={lib.moe_max_experts()} != "
                    f"kernels.MOE_MAX_EXPERTS={MOE_MAX_EXPERTS}")
            err = lib.moe_init()
            if err != 0:
                raise RuntimeError(f"moe_init failed: CUDA error {err}")
            if (lib.rwkv6_head_max(), lib.rwkv6_chunk_len()) != (
                    RWKV6_MAX_K, RWKV6_CHUNK):
                raise RuntimeError(
                    f"csrc rwkv6 (KMAX, L)=({lib.rwkv6_head_max()}, "
                    f"{lib.rwkv6_chunk_len()}) != kernels.(RWKV6_MAX_K, "
                    f"RWKV6_CHUNK)=({RWKV6_MAX_K}, {RWKV6_CHUNK})")
            if lib.mamba_scan_max_state() != MAMBA_SCAN_MAX_STATE:
                raise RuntimeError(
                    f"csrc mamba_scan NMAX={lib.mamba_scan_max_state()} != "
                    f"kernels.MAMBA_SCAN_MAX_STATE={MAMBA_SCAN_MAX_STATE}")
            _lib = lib
    return _lib


def stream_of(t) -> int:
    """The handle of the current CUDA stream of ``t``'s device: kernels
    launch there, so a launch inside ``torch.cuda.graph`` is recorded."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def sm_count(device) -> int:
    """Streaming multiprocessors of ``device``'s card: the persistent and
    split launches size their grids by it."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def strides(*values: int) -> ctypes.Array:
    """Element strides as the ``long long[]`` the attention entry points
    read on the host (the array lives for the duration of the call)."""
    return (ctypes.c_longlong * len(values))(*values)
