"""ctypes binding of the CUDA RMSNorm (``csrc/norm.cu``).

Replaces ``src/repro/kernels/rmsnorm/kernel.py:rmsnorm_pallas``: one warp
per row of ``x [N, d]``, fp32 sum of squares, output in the input dtype.
Bound and design notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from .._build import library, stream_of

_ENTRY = {torch.bfloat16: "rmsnorm_bf16", torch.float32: "rmsnorm_f32"}


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
                 eps: float) -> None:
    """Launch on the current stream; the wrapper has checked the operands."""
    n, d = x.shape
    fn = getattr(library(), _ENTRY[x.dtype])
    err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d, eps,
             stream_of(x))
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {err}")
