"""ctypes binding of the CUDA fused branch GEMM (``csrc/gemm.cu``).

Replaces ``src/repro/kernels/branch_gemm/kernel.py:branch_gemm_pallas``:
N independent equal-shape GEMMs ``x [N,M,K] @ w [N,K,F] → [N,M,F]`` in one
launch, fp32 accumulation, output in the input dtype.  Three routes, one
entry point each: ``wgmma`` (bf16, a TMA ring feeding warpgroup wgmma, BM x
BN tiles from :data:`WGMMA_TILES`), ``simple`` (bf16 WMMA on 64x64 tiles,
any shape) and ``fp32`` (FMA).  Bound and design notes are in the CUDA
source.
"""
from __future__ import annotations

import torch

from .._build import library, stream_of

# (BM, BN) instantiations of the wgmma route, largest first; must match
# gemm_has_wgmma_tiles in csrc/gemm.cu (checked when the library loads).
# BM 128 runs two consumer warpgroups a block, BM 64 one (two blocks an SM).
WGMMA_TILES = ((128, 256), (128, 128), (64, 128), (64, 64))

_ENTRY = {"wgmma": "branch_gemm_bf16", "simple": "branch_gemm_simple_bf16",
          "fp32": "branch_gemm_f32"}


def branch_gemm_cuda(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                     route: str, tiles: tuple[int, int] | None = None) -> None:
    """Launch ``route`` on the current stream (``tiles`` = (BM, BN) for
    wgmma); the wrapper has checked the operands."""
    n, m, k = x.shape
    f = w.shape[-1]
    fn = getattr(library(), _ENTRY[route])
    shape = (n, m, k, f) + (tiles if route == "wgmma" else ())
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), *shape,
             stream_of(x))
    if err != 0:
        raise RuntimeError(f"branch_gemm {route} launch failed: CUDA error "
                           f"{err}")
