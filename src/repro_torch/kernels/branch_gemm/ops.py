"""Public wrapper of the fused branch GEMM.

CPU tensors take the plain version (``ref.py``).  CUDA tensors launch the
kernel or raise: any M, K, F is taken (the kernel masks its edges), so no
shape needs a fallback.  ``launches`` counts kernel launches — the count a
run reads to show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from .. import TILE_M, use_kernel
from .kernel import _ENTRY, branch_gemm_cuda
from .ref import branch_gemm_ref

launches = 0
_GRID_LIMIT = 65535     # blockIdx.y (row tiles) and blockIdx.z (branches)


def branch_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused N-branch GEMM: [N,M,K] @ [N,K,F] → [N,M,F]."""
    global launches
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"branch_gemm wants [N,M,K] @ [N,K,F], got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    n, m, k = x.shape
    if w.shape[0] != n or w.shape[1] != k:
        raise ValueError(f"shape mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    if not use_kernel(x, w):
        return branch_gemm_ref(x, w)
    if x.dtype != w.dtype or x.dtype not in _ENTRY:
        raise TypeError(f"branch_gemm takes bf16 or fp32 operands of one "
                        f"dtype, got {x.dtype} @ {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("branch_gemm needs contiguous operands")
    if n > _GRID_LIMIT or -(-m // TILE_M) > _GRID_LIMIT:
        raise ValueError(f"branch_gemm grid too large for N={n}, M={m}")
    out = torch.empty((n, m, w.shape[2]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    branch_gemm_cuda(x, w, out)
    launches += 1
    return out
