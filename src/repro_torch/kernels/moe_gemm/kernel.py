"""ctypes binding of the CUDA grouped expert MLP (``csrc/moe.cu``).

Replaces ``src/repro/kernels/moe_gemm/kernel.py:moe_mlp_pallas``: stage 1
writes ``h = silu(buf @ gate) * (buf @ up)`` per expert, rounded to the
dtype, to a scratch ``[E, C, f]``; stage 2 computes ``h @ down``.  Bound and
design notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from .._build import library, stream_of

_ENTRY = {torch.bfloat16: "moe_mlp_bf16", torch.float32: "moe_mlp_f32"}


def moe_mlp_cuda(buf: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                 down: torch.Tensor, out: torch.Tensor) -> None:
    """Launch both stages on the current stream; the wrapper has checked the
    operands.  The scratch comes from ``torch.empty``, so a launch inside a
    CUDA graph records it from the graph's pool."""
    e, c, d = buf.shape
    f = gate.shape[-1]
    h = torch.empty((e, c, f), dtype=buf.dtype, device=buf.device)
    fn = getattr(library(), _ENTRY[buf.dtype])
    err = fn(buf.data_ptr(), gate.data_ptr(), up.data_ptr(), down.data_ptr(),
             h.data_ptr(), out.data_ptr(), e, c, d, f, stream_of(buf))
    if err != 0:
        raise RuntimeError(f"moe_gemm launch failed: CUDA error {err}")
