"""Plain PyTorch version of paged single-token decode attention.

Layout contract (the engine's page pool — write-friendly at
``(page, offset)``):

    q:            [B, H, Dk]        one query token per sequence
    k_pages:      [P, ps, KVH, Dk]  physical KV pages (page 0 = null page)
    v_pages:      [P, ps, KVH, Dv]
    block_tables: [B, MAXP] int32   logical page i of seq b -> physical page
    lengths:      [B] int32         attended positions: [starts, lengths)
    starts:       [B] int32 | None  window lower bound (None -> 0)

Masking is positional, so trailing table entries may point at the null page.
The pages are gathered into a ``[B, MAXP*ps, KVH, D]`` slab and attended by
the routine the dense decode's plain version uses, so the two agree exactly.
"""
import torch

from ..decode_attention.ref import attend_one


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor,
                               starts: torch.Tensor | None = None,
                               scale: float | None = None) -> torch.Tensor:
    """Gather-then-mask reference → [B, H, Dv]."""
    b, _, dk = q.shape
    ps, kvh = k_pages.shape[1], k_pages.shape[2]
    maxp = block_tables.shape[1]
    scale = dk ** -0.5 if scale is None else scale
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, maxp * ps, kvh, dk)
    v = v_pages[bt].reshape(b, maxp * ps, kvh, v_pages.shape[-1])
    posn = torch.arange(maxp * ps, device=q.device)[None, :]
    valid = posn < lengths[:, None]
    if starts is not None:
        valid &= posn >= starts[:, None]
    return attend_one(q, k, v, valid, scale)
