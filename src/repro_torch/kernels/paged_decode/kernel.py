"""ctypes bindings of the CUDA paged decode attention: the GQA form
(``csrc/attention.cu``) and the MLA form (``csrc/mla_decode.cu``).

Replaces
``src/repro/kernels/paged_decode/kernel.py:paged_decode_attention_pallas``
(the GQA form): the decode kernel's device routine and routes, with each
position's K/V row found through the block table (page ``bt[b, t // ps]``,
offset ``t % ps``) and the mask ``starts <= t < lengths``.  Pages are read
in the engine layout ``[P, ps, KVH, D]``.  Bound and design notes are in the
CUDA source.

The MLA form replaces
``src/repro/kernels/paged_decode/ops.py:paged_mla_decode_attention``
after its absorption: one latent KV head under all query heads, the heads
the M dimension of the score and value products, ``ckv`` and ``kpe`` pages
read through their own strides.  Bound and design notes are in
``csrc/mla_decode.cu``.
"""
from __future__ import annotations

import torch

from .. import MLA_TILE
from .._build import library, sm_count, stream_of, strides
from ..decode_attention.kernel import scratch

_ENTRY = {"mma": "paged_decode_bf16", "simple": "paged_decode_simple_bf16",
          "fp32": "paged_decode_f32"}


def paged_decode_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_tables: torch.Tensor,
                      lengths: torch.Tensor, starts: torch.Tensor | None,
                      out: torch.Tensor, scale: float, route: str) -> None:
    """Launch ``route`` on the current stream; the wrapper has checked the
    operands.  The table's ``MAXP·ps`` positions are split as the dense
    decode splits a slab of that length."""
    b, h, dk = q.shape
    ps, kvh = k_pages.shape[1], k_pages.shape[2]
    dv = v_pages.shape[-1]
    maxp = block_tables.shape[1]
    part, tail = scratch(route, b, h, kvh, maxp * ps, dv, q.device)
    st = strides(q.stride(0), q.stride(1), *k_pages.stride()[:3],
                 *v_pages.stride()[:3], out.stride(0), out.stride(1))
    fn = getattr(library(), _ENTRY[route])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(),
             None if starts is None else starts.data_ptr(),
             lengths.data_ptr(), None if part is None else part.data_ptr(),
             out.data_ptr(), b, h, kvh, maxp, ps, dk, dv, st, scale, *tail,
             stream_of(q))
    if err != 0:
        raise RuntimeError(f"paged_decode {route} launch failed: CUDA error "
                           f"{err}")


# -- the MLA form (csrc/mla_decode.cu) -------------------------------------------

_MLA_ENTRY = {torch.bfloat16: "mla_decode_bf16", torch.float32: "mla_decode_f32"}
_MLA_HEADS = 16          # query heads per block (csrc HG)


def mla_split_len(b: int, h: int, t: int, device: torch.device) -> int:
    """Positions each block walks: enough splits of the ``t`` table
    positions for about two blocks per SM over the ``b × ⌈h/16⌉`` (row,
    head group) pairs, each a whole number of ``MLA_TILE``-position tiles."""
    sms = sm_count(device)
    pairs = b * -(-h // _MLA_HEADS)
    n = max(1, min(-(-2 * sms // pairs), -(-t // MLA_TILE)))
    return -(-(-(-t // n)) // MLA_TILE) * MLA_TILE


def paged_mla_decode_cuda(q_lat: torch.Tensor, q_pe: torch.Tensor,
                          ckv_pages: torch.Tensor, kpe_pages: torch.Tensor,
                          block_tables: torch.Tensor, lengths: torch.Tensor,
                          out: torch.Tensor, scale: float) -> None:
    """Launch on the current stream; the wrapper has checked the operands.
    The fp32 scratch holds per (row, head, split) the partial output
    (``rank`` padded to 16) and its max and sum (``torch.empty``, so a
    launch inside a CUDA graph takes it from the graph's pool)."""
    b, h, r = q_lat.shape
    p = q_pe.shape[-1]
    ps = ckv_pages.shape[1]
    maxp = block_tables.shape[1]
    split = mla_split_len(b, h, maxp * ps, q_lat.device)
    n_split = -(-(maxp * ps) // split)
    rpad = -(-r // 16) * 16
    part = torch.empty(b * h * n_split * (rpad + 2), dtype=torch.float32,
                       device=q_lat.device)
    st = strides(q_lat.stride(0), q_lat.stride(1), q_pe.stride(0),
                 q_pe.stride(1), *ckv_pages.stride()[:2],
                 *kpe_pages.stride()[:2], out.stride(0), out.stride(1))
    fn = getattr(library(), _MLA_ENTRY[q_lat.dtype])
    err = fn(q_lat.data_ptr(), q_pe.data_ptr(), ckv_pages.data_ptr(),
             kpe_pages.data_ptr(), block_tables.data_ptr(),
             lengths.data_ptr(), part.data_ptr(), out.data_ptr(), b, h, r, p,
             maxp, ps, split, st, scale, stream_of(q_lat))
    if err != 0:
        raise RuntimeError(f"paged_decode MLA launch failed: CUDA error {err}")
