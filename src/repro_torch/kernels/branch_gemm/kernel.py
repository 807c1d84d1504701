"""ctypes binding of the CUDA fused branch GEMM (``csrc/gemm.cu``).

Replaces ``src/repro/kernels/branch_gemm/kernel.py:branch_gemm_pallas``:
N independent equal-shape GEMMs ``x [N,M,K] @ w [N,K,F] → [N,M,F]`` in one
launch, fp32 accumulation, output in the input dtype.  The branch index is
``blockIdx.z``; each block walks K through shared-memory tiles.  Bound and
design notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from .._build import library, stream_of

_ENTRY = {torch.bfloat16: "branch_gemm_bf16", torch.float32: "branch_gemm_f32"}


def branch_gemm_cuda(x: torch.Tensor, w: torch.Tensor,
                     out: torch.Tensor) -> None:
    """Launch on the current stream; the wrapper has checked the operands."""
    n, m, k = x.shape
    f = w.shape[-1]
    fn = getattr(library(), _ENTRY[x.dtype])
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, m, k, f,
             stream_of(x))
    if err != 0:
        raise RuntimeError(f"branch_gemm launch failed: CUDA error {err}")
