"""ctypes binding of the CUDA decode attention (``csrc/attention.cu``).

Replaces ``src/repro/kernels/decode_attention/kernel.py:decode_attention_pallas``:
flash-decoding over chunks of ``DECODE_CHUNK`` cache positions, one block per
(chunk, KV head, batch row) serving all query heads of the group, then a
combine pass.  The cache ``[B,T,KVH,D]`` is read in place.  Bound and design
notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from .. import DECODE_CHUNK
from .._build import library, stream_of, strides

_ENTRY = {torch.bfloat16: "decode_attention_bf16",
          torch.float32: "decode_attention_f32"}


def partials(b: int, h: int, t: int, dv: int,
             device: torch.device) -> torch.Tensor:
    """Scratch of the split-KV pass: per (row, head, chunk) the fp32 partial
    output, then its max and sum (``torch.empty``, so a launch inside a CUDA
    graph records it from the graph's pool)."""
    n_chunks = -(-t // DECODE_CHUNK)
    return torch.empty(b * h * n_chunks * (dv + 2), dtype=torch.float32,
                       device=device)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor, out: torch.Tensor) -> None:
    """Launch on the current stream; the wrapper has checked the operands."""
    b, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    part = partials(b, h, t, d, q.device)
    st = strides(q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
                 valid.stride(0), out.stride(0), out.stride(1))
    fn = getattr(library(), _ENTRY[q.dtype])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
             part.data_ptr(), out.data_ptr(), b, h, kvh, t, d, st,
             d ** -0.5, stream_of(q))
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
