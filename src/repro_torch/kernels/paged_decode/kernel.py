"""ctypes binding of the CUDA paged decode attention (``csrc/attention.cu``).

Replaces
``src/repro/kernels/paged_decode/kernel.py:paged_decode_attention_pallas``
(the GQA form): the decode kernel's device routine, with each position's
K/V row found through the block table (page ``bt[b, t // ps]``, offset
``t % ps``) and the mask ``starts <= t < lengths``.  Pages are read in the
engine layout ``[P, ps, KVH, D]``.  Bound and design notes are in the CUDA
source.
"""
from __future__ import annotations

import torch

from .._build import library, stream_of, strides
from ..decode_attention.kernel import partials

_ENTRY = {torch.bfloat16: "paged_decode_bf16", torch.float32: "paged_decode_f32"}


def paged_decode_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_tables: torch.Tensor,
                      lengths: torch.Tensor, starts: torch.Tensor | None,
                      out: torch.Tensor, scale: float) -> None:
    """Launch on the current stream; the wrapper has checked the operands."""
    b, h, dk = q.shape
    ps, kvh = k_pages.shape[1], k_pages.shape[2]
    dv = v_pages.shape[-1]
    maxp = block_tables.shape[1]
    part = partials(b, h, maxp * ps, dv, q.device)
    st = strides(q.stride(0), q.stride(1), *k_pages.stride()[:3],
                 *v_pages.stride()[:3], out.stride(0), out.stride(1))
    fn = getattr(library(), _ENTRY[q.dtype])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(),
             None if starts is None else starts.data_ptr(),
             lengths.data_ptr(), part.data_ptr(), out.data_ptr(), b, h, kvh,
             maxp, ps, dk, dv, st, scale, stream_of(q))
    if err != 0:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {err}")
