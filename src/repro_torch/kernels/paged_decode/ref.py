"""Plain PyTorch version of paged single-token decode attention (GQA, and
the MLA form over latent pages).

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


def absorb_query(q_nope: torch.Tensor, wk_b: torch.Tensor,
                 matmul=torch.matmul) -> torch.Tensor:
    """MLA's matrix absorption ``q_lat[.., h, r] = Σ_d q_nope[.., h, d] ·
    wk_b[r, h, d]``: q_nope ``[.., H, D_nope]``, wk_b ``[rank, H, D_nope]``
    → ``[.., H, rank]`` in q_nope's dtype, one batched product per head
    with fp32 accumulation and one rounding (the JAX package's einsum with
    ``preferred_element_type=float32``).  ``matmul`` is the product (the
    model passes one that also takes ``DTensor``s)."""
    h, nope = q_nope.shape[-2:]
    q = q_nope.reshape(-1, h, nope).transpose(0, 1)          # [H, N, D]
    lat = matmul(q, wk_b.permute(1, 2, 0))                   # [H, N, rank]
    return lat.transpose(0, 1).reshape(*q_nope.shape[:-1], wk_b.shape[0])


def paged_mla_decode_attention_ref(q_nope: torch.Tensor, q_pe: torch.Tensor,
                                   ckv_pages: torch.Tensor,
                                   kpe_pages: torch.Tensor,
                                   wk_b: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   lengths: torch.Tensor,
                                   scale: float) -> torch.Tensor:
    """MLA form, as the JAX package's wrapper computes it: absorb ``q_nope``
    through ``wk_b``, then one kvh = 1 paged attention of ``[q_lat ‖ q_pe]``
    against ``[ckv ‖ kpe]`` pages with ``V = ckv`` → the latent output
    ``[B, H, rank]``.  Concatenating the pages copies the pool; the kernel
    reads the two page arrays where they are."""
    q_cat = torch.cat([absorb_query(q_nope, wk_b), q_pe], dim=-1)
    k_cat = torch.cat([ckv_pages, kpe_pages], dim=-1)[:, :, None, :]
    return paged_decode_attention_ref(q_cat, k_cat, ckv_pages[:, :, None, :],
                                      block_tables, lengths, None, scale)
