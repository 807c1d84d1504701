"""Public wrapper of the paged decode attention kernel (GQA).

CPU tensors take the plain version (``ref.py``).  CUDA tensors launch the
kernel or raise: any page size and table width, any Dk and Dv up to 128
(Dv may differ from Dk), at most 16 query heads per KV head.  The block
table, ``lengths`` and ``starts`` are int32 on the card.  ``launches``
counts kernel launches (the split pass and its combine count as one).  A
row with no attended position gives what the plain version and the JAX
package give: V averaged over every table entry of the row, null pages
included.  The MLA form of the JAX package (``paged_mla_decode_attention``)
is not ported yet.
"""
from __future__ import annotations

import torch

from .. import use_kernel
from ..decode_attention.ops import check_decode_operands
from .kernel import paged_decode_cuda
from .ref import paged_decode_attention_ref

launches = 0


def _int32_rows(name: str, t: torch.Tensor, shape: tuple[int, ...]) -> None:
    if (t.dtype != torch.int32 or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous int32 {list(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor,
                           starts: torch.Tensor | None = None,
                           scale: float | None = None) -> torch.Tensor:
    """Engine-layout wrapper: q [B,H,Dk]; pages [P,ps,KVH,Dk|Dv];
    block_tables [B,MAXP]; lengths/starts [B] → [B,H,Dv]."""
    global launches
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.dim() != 4:
        raise ValueError(f"paged_decode wants q [B,H,Dk], pages "
                         f"[P,ps,KVH,D], got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    b, h, dk = q.shape
    kvh = k_pages.shape[2]
    if (k_pages.shape[3] != dk or v_pages.shape[:3] != k_pages.shape[:3]
            or kvh == 0 or h % kvh or block_tables.dim() != 2
            or block_tables.shape[0] != b):
        raise ValueError(f"paged_decode shape mismatch q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}, block table "
                         f"{tuple(block_tables.shape)}")
    scale = float(dk ** -0.5 if scale is None else scale)
    others = (v_pages, block_tables, lengths) + (
        () if starts is None else (starts,))
    if not use_kernel(q, k_pages, *others):
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          lengths, starts, scale)
    check_decode_operands("paged_decode", q, k_pages, v_pages)
    _int32_rows("block_tables", block_tables, tuple(block_tables.shape))
    _int32_rows("lengths", lengths, (b,))
    if starts is not None:
        _int32_rows("starts", starts, (b,))
    out = torch.empty((b, h, v_pages.shape[-1]), dtype=q.dtype,
                      device=q.device)
    if out.numel() == 0 or block_tables.shape[1] * k_pages.shape[1] == 0:
        return out.zero_()
    paged_decode_cuda(q, k_pages, v_pages, block_tables, lengths, starts,
                      out, scale)
    launches += 1
    return out
