"""ctypes binding of the CUDA grouped ragged-M GEMM (``csrc/gemm.cu``).

Replaces ``src/repro/kernels/grouped_gemm/kernel.py:grouped_gemm_pallas``:
rows of N groups concatenated WITHOUT padding, ``x [sum M, K]`` against
``w [N, K, F]`` → ``[sum M, F]``.  Row tile ``t`` (``blockIdx.y``) reads
``(group, row_start, row_end)`` from a device int32 table and masks the
rows past its group's end, which replaces the reference's per-group
zero-padding copy.  Bound and design notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from .._build import library, stream_of

_ENTRY = {torch.bfloat16: "grouped_gemm_bf16", torch.float32: "grouped_gemm_f32"}


def grouped_gemm_cuda(x: torch.Tensor, w: torch.Tensor, table: torch.Tensor,
                      out: torch.Tensor) -> None:
    """Launch on the current stream; the wrapper has checked the operands."""
    k, f = w.shape[1], w.shape[2]
    fn = getattr(library(), _ENTRY[x.dtype])
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), table.data_ptr(),
             table.shape[0], k, f,
             stream_of(x))
    if err != 0:
        raise RuntimeError(f"grouped_gemm launch failed: CUDA error {err}")
