"""ctypes binding of the CUDA flash attention (``csrc/attention.cu``).

Replaces ``src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas``:
one block per (64-row query tile, head, batch row) walks the K/V tiles of its
causal/window band with an online softmax, bf16 WMMA products with fp32
accumulation.  Operands are read in the model layout through strides.  Bound
and design notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from .._build import library, stream_of, strides

_ENTRY = {torch.bfloat16: "flash_attention_bf16",
          torch.float32: "flash_attention_f32"}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, causal: bool, window: int,
                         scale: float) -> None:
    """Launch on the current stream; the wrapper has checked the operands."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    st = strides(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3])
    fn = getattr(library(), _ENTRY[q.dtype])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
             t, h, kvh, d, st, int(causal), int(window), scale, stream_of(q))
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
