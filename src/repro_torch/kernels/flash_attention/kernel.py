"""ctypes binding of the CUDA flash attention (``csrc/attention.cu``).

Replaces ``src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas``:
causal/windowed GQA prefill with an online softmax and fp32 accumulation,
operands read in the model layout through strides.  Three routes, one entry
point each: ``wgmma`` (bf16: TMA loads, warpgroup wgmma, S, P and O in
registers), ``simple`` (bf16 WMMA with S, P and O in shared memory, any D up
to 128) and ``fp32`` (FMA).  Bound and design notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from .._build import library, stream_of, strides

_ENTRY = {"wgmma": "flash_attention_bf16",
          "simple": "flash_attention_simple_bf16",
          "fp32": "flash_attention_f32"}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, causal: bool, window: int,
                         scale: float, route: str) -> None:
    """Launch ``route`` on the current stream; the wrapper has checked the
    operands."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    st = strides(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3])
    fn = getattr(library(), _ENTRY[route])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
             t, h, kvh, d, st, int(causal), int(window), scale, stream_of(q))
    if err != 0:
        raise RuntimeError(f"flash_attention {route} launch failed: CUDA "
                           f"error {err}")
