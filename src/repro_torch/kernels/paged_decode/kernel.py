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
read through their own strides.  Three routes: ``wgmma`` (DeepSeek-V3's
rank 512 and rope 64 in bf16: 64 heads a block, a TMA ring of 64-position
K tiles gathered through the table, warpgroup MMA, the splits of a (row,
head group) one cluster combined in distributed shared memory),
``simple`` (other bf16 shapes: WMMA over 16 heads a block, partials through
a scratch buffer and a combine kernel) and ``fp32`` (the simple route's
structure on the CUDA cores).  Bound and design notes are in
``csrc/mla_decode.cu``.
"""
from __future__ import annotations

import torch

from .. import MLA_MAX_SPLITS, MLA_TILE, MLA_WGMMA_TILE
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

_MLA_ENTRY = {"simple": "mla_decode_bf16", "fp32": "mla_decode_f32"}
_MLA_HEADS = 16          # query heads per block of the simple and fp32
                         # routes (csrc HG)
MLA_WGMMA_HEADS = 64     # query heads per block of the wgmma route (csrc
                         # mla_wg::HB, wgmma's M)


def mla_split_len(b: int, h: int, t: int, device: torch.device) -> int:
    """Positions each block of the simple and fp32 routes walks: enough
    splits of the ``t`` table positions for about two blocks per SM over the
    ``b × ⌈h/16⌉`` (row, head group) pairs, each a whole number of
    ``MLA_TILE``-position tiles."""
    sms = sm_count(device)
    pairs = b * -(-h // _MLA_HEADS)
    n = max(1, min(-(-2 * sms // pairs), -(-t // MLA_TILE)))
    return -(-(-(-t // n)) // MLA_TILE) * MLA_TILE


def mla_wgmma_split_len(b: int, h: int, t: int, sms: int) -> int:
    """Positions each block of the wgmma route walks: as many splits of the
    ``t`` table positions as fit one block per two SMs over the
    ``b × ⌈h/64⌉`` (row, head group) pairs (at least one, at most
    ``MLA_MAX_SPLITS``, the blocks of one cluster), each a whole number of
    ``MLA_WGMMA_TILE``-position tiles.  A block takes a whole SM (222 KB of
    shared memory) and a cluster's blocks one GPC: at DeepSeek-V3's serving
    shape (8 rows, 2 head groups, 1024 positions) 8 splits (16 clusters of
    8) measured slower on the H100 than the 4 this rule picks
    (``chip_smoke.py`` times both, PERF.md §6)."""
    pairs = max(1, b * -(-h // MLA_WGMMA_HEADS))
    n = max(1, min(sms // (2 * pairs), -(-t // MLA_WGMMA_TILE),
                   MLA_MAX_SPLITS))
    return -(-(-(-t // n)) // MLA_WGMMA_TILE) * MLA_WGMMA_TILE


def paged_mla_decode_cuda(q_lat: torch.Tensor, q_pe: torch.Tensor,
                          ckv_pages: torch.Tensor, kpe_pages: torch.Tensor,
                          block_tables: torch.Tensor, lengths: torch.Tensor,
                          out: torch.Tensor, scale: float, route: str,
                          split_len: int | None = None) -> None:
    """Launch ``route`` on the current stream; the wrapper has checked the
    operands.  The simple and fp32 routes take an fp32 scratch of, per
    (row, head, split), the partial output (``rank`` padded to 16) and its
    max and sum (``torch.empty``, so a launch inside a CUDA graph takes it
    from the graph's pool); the wgmma route combines its splits on chip and
    takes none.  ``split_len`` (positions a block) overrides the route's
    rule, for a measurement."""
    b, h, r = q_lat.shape
    p = q_pe.shape[-1]
    ps = ckv_pages.shape[1]
    maxp = block_tables.shape[1]
    st = strides(q_lat.stride(0), q_lat.stride(1), q_pe.stride(0),
                 q_pe.stride(1), *ckv_pages.stride()[:2],
                 *kpe_pages.stride()[:2], out.stride(0), out.stride(1))
    ptrs = [x.data_ptr() for x in (q_lat, q_pe, ckv_pages, kpe_pages,
                                   block_tables, lengths)]
    if route == "wgmma":
        split = split_len or mla_wgmma_split_len(b, h, maxp * ps,
                                                 sm_count(q_lat.device))
        err = library().mla_decode_wgmma_bf16(
            *ptrs, out.data_ptr(), b, h, r, p, maxp, ps, ckv_pages.shape[0],
            split, st, scale, stream_of(q_lat))
    else:
        split = split_len or mla_split_len(b, h, maxp * ps, q_lat.device)
        n_split = -(-(maxp * ps) // split)
        rpad = -(-r // 16) * 16
        part = torch.empty(b * h * n_split * (rpad + 2), dtype=torch.float32,
                           device=q_lat.device)
        err = getattr(library(), _MLA_ENTRY[route])(
            *ptrs, part.data_ptr(), out.data_ptr(), b, h, r, p, maxp, ps,
            split, st, scale, stream_of(q_lat))
    if err != 0:
        raise RuntimeError(f"paged_decode MLA {route} launch failed: CUDA "
                           f"error {err}")
