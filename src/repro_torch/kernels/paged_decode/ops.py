"""Public wrappers of the paged decode attention kernels: the GQA form and
the MLA form (``paged_mla_decode_attention``, the JAX package's signature).

CPU tensors take the plain versions (``ref.py``).  CUDA tensors launch the
kernel or raise.  GQA: any page size and table width, any Dk and Dv up to
128 (Dv may differ from Dk), at most 16 query heads per KV head.  MLA: any
page size, table width and head count, latent rank up to 512 and rope dims
up to 64.  The block table, ``lengths`` and ``starts`` are int32 on the
card.  The GQA form takes the dense decode's routes by the same rule
(``decode_attention.ops.route``), so pages and the slab of one dtype and
head dims take the same route.  ``launches`` (GQA) and ``mla_launches``
(MLA) count kernel launches (a split pass and its combine count as one);
``launches_by_route`` splits the GQA ones by route.  A row with no attended
position gives what the plain versions and the JAX package give: V
averaged over every table entry of the row, null pages included.
"""
from __future__ import annotations

import torch

from .. import use_kernel
from ..decode_attention.ops import (DTYPES, ROUTES, check_decode_operands,
                                    route)
from .kernel import _MLA_ENTRY, paged_decode_cuda, paged_mla_decode_cuda
from .ref import (absorb_query, paged_decode_attention_ref,
                  paged_mla_decode_attention_ref)

launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)
mla_launches = 0
MLA_MAX_RANK = 512      # csrc MAX_R
MLA_MAX_ROPE = 64       # csrc MAX_P


def _int32_rows(name: str, t: torch.Tensor, shape: tuple[int, ...]) -> None:
    if (t.dtype != torch.int32 or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous int32 {list(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _check(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
           block_tables: torch.Tensor) -> None:
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


def _launch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
            block_tables: torch.Tensor, lengths: torch.Tensor,
            starts: torch.Tensor | None, scale: float,
            dtypes: tuple[torch.dtype, ...],
            path: str | None) -> torch.Tensor:
    global launches
    b, h = q.shape[:2]
    check_decode_operands("paged_decode", q, k_pages, v_pages, dtypes)
    _int32_rows("block_tables", block_tables, tuple(block_tables.shape))
    _int32_rows("lengths", lengths, (b,))
    if starts is not None:
        _int32_rows("starts", starts, (b,))
    out = torch.empty((b, h, v_pages.shape[-1]), dtype=q.dtype,
                      device=q.device)
    if out.numel() == 0 or block_tables.shape[1] * k_pages.shape[1] == 0:
        return out.zero_()
    path = path or route(q, k_pages, v_pages)
    paged_decode_cuda(q, k_pages, v_pages, block_tables, lengths, starts,
                      out, scale, path)
    launches += 1
    launches_by_route[path] += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor,
                           starts: torch.Tensor | None = None,
                           scale: float | None = None) -> torch.Tensor:
    """Engine-layout wrapper: q [B,H,Dk]; pages [P,ps,KVH,Dk|Dv];
    block_tables [B,MAXP]; lengths/starts [B] → [B,H,Dv]."""
    _check(q, k_pages, v_pages, block_tables)
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    others = (v_pages, block_tables, lengths) + (
        () if starts is None else (starts,))
    if not use_kernel(q, k_pages, *others):
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          lengths, starts, scale)
    return _launch(q, k_pages, v_pages, block_tables, lengths, starts, scale,
                   DTYPES, None)


def paged_decode_simple_bf16(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor,
                             block_tables: torch.Tensor,
                             lengths: torch.Tensor,
                             starts: torch.Tensor | None = None,
                             scale: float | None = None) -> torch.Tensor:
    """The simple route at any bf16 shape on the card, so that a
    measurement can hold the mma route against it; counted as a ``simple``
    launch."""
    _check(q, k_pages, v_pages, block_tables)
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    others = (v_pages, block_tables, lengths) + (
        () if starts is None else (starts,))
    if not use_kernel(q, k_pages, *others):
        raise ValueError("paged_decode_simple_bf16 needs CUDA tensors")
    return _launch(q, k_pages, v_pages, block_tables, lengths, starts, scale,
                   (torch.bfloat16,), "simple")


def paged_mla_decode_attention(q_nope: torch.Tensor, q_pe: torch.Tensor,
                               ckv_pages: torch.Tensor,
                               kpe_pages: torch.Tensor, wk_b: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """MLA over compressed latent pages: q_nope ``[B,H,D_nope]``, q_pe
    ``[B,H,D_pe]``, ckv_pages ``[P,ps,rank]``, kpe_pages ``[P,ps,D_pe]``,
    wk_b ``[rank,H,D_nope]``; block_tables ``[B,MAXP]``, lengths ``[B]``
    (positions ``[0, lengths)`` are attended) → the latent output
    ``[B,H,rank]`` (the caller applies ``W_vb``).  ``q_nope`` is absorbed
    through ``wk_b`` here, outside the kernel, as in the JAX package; the
    kernel then attends ``[q_lat ‖ q_pe]`` against the two page arrays
    without concatenating them."""
    global mla_launches
    if (q_nope.dim() != 3 or q_pe.dim() != 3 or ckv_pages.dim() != 3
            or kpe_pages.dim() != 3 or wk_b.dim() != 3
            or block_tables.dim() != 2):
        raise ValueError(
            f"paged_mla_decode wants q [B,H,D], pages [P,ps,D], wk_b "
            f"[rank,H,D], table [B,MAXP], got {tuple(q_nope.shape)}, "
            f"{tuple(q_pe.shape)}, {tuple(ckv_pages.shape)}, "
            f"{tuple(kpe_pages.shape)}, {tuple(wk_b.shape)}, "
            f"{tuple(block_tables.shape)}")
    b, h, nope = q_nope.shape
    rank, rope = ckv_pages.shape[-1], kpe_pages.shape[-1]
    if (q_pe.shape[:2] != (b, h) or q_pe.shape[2] != rope
            or kpe_pages.shape[:2] != ckv_pages.shape[:2]
            or tuple(wk_b.shape) != (rank, h, nope)
            or block_tables.shape[0] != b):
        raise ValueError(
            f"paged_mla_decode shape mismatch q_nope {tuple(q_nope.shape)}, "
            f"q_pe {tuple(q_pe.shape)}, ckv {tuple(ckv_pages.shape)}, kpe "
            f"{tuple(kpe_pages.shape)}, wk_b {tuple(wk_b.shape)}, table "
            f"{tuple(block_tables.shape)}")
    scale = float(scale)
    operands = (q_nope, q_pe, ckv_pages, kpe_pages, wk_b, block_tables,
                lengths)
    if not use_kernel(*operands):
        return paged_mla_decode_attention_ref(*operands, scale)
    dtypes = {q_nope.dtype, q_pe.dtype, ckv_pages.dtype, kpe_pages.dtype,
              wk_b.dtype}
    if len(dtypes) != 1 or q_nope.dtype not in _MLA_ENTRY:
        raise TypeError(f"paged_mla_decode takes bf16 or fp32 operands of "
                        f"one dtype, got {sorted(map(str, dtypes))}")
    if rank > MLA_MAX_RANK or rope > MLA_MAX_ROPE or rank == 0:
        raise ValueError(f"paged_mla_decode takes a latent rank of 1 to "
                         f"{MLA_MAX_RANK} and up to {MLA_MAX_ROPE} rope "
                         f"dims, got {rank} and {rope}")
    if any(t.stride(-1) != 1 for t in (q_pe, ckv_pages, kpe_pages)):
        raise ValueError("paged_mla_decode needs the last dim contiguous")
    if b > 65535 or -(-h // 16) > 65535:
        raise ValueError(f"paged_mla_decode grid too large for B={b}, H={h}")
    _int32_rows("block_tables", block_tables, tuple(block_tables.shape))
    _int32_rows("lengths", lengths, (b,))
    out = torch.empty((b, h, rank), dtype=q_nope.dtype, device=q_nope.device)
    if out.numel() == 0 or block_tables.shape[1] * ckv_pages.shape[1] == 0:
        return out.zero_()
    paged_mla_decode_cuda(absorb_query(q_nope, wk_b), q_pe, ckv_pages,
                          kpe_pages, block_tables, lengths, out, scale)
    mla_launches += 1
    return out
