"""Attention: GQA (optionally sliding-window) with prefill, single-token
decode against a dense KV slab and decode against paged KV, plus the causal
window mask and params the dense export uses.

Kernel dispatch: with ``use_kernels=True`` prefill calls the port's flash
attention kernel (with the layer's window; the JAX package's kernel route
drops it, ROADMAP C2), dense decode the decode-attention kernel and paged
decode the paged-decode kernel.  Each wrapper runs its plain version on CPU
tensors.  Otherwise the plain math of :func:`_sdpa` runs.

Caches are written in place (``index_put_`` on the preallocated tensors)
and returned: a CUDA graph replays against fixed addresses, so the decode
step must update the static cache rather than build a new one.

Not ported: MLA (DeepSeek, ROADMAP A6), the flash-structured
``chunked_attention`` of long prefill (its custom VJP comes with training,
A9; the plain path raises above its threshold instead) and the JAX
package's ``REPRO_*`` performance flags (their defaults are what runs here).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .layers import apply_rope, init_linear, linear

NEG_INF = -1e30
# s·t above which the JAX package's plain path switches to
# chunked_attention (not ported); the port's plain path raises there
CHUNK_THRESHOLD = 1 << 22


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: int | None) -> torch.Tensor:
    """[qs, ks] boolean: causal AND within window (window=None → pure causal)."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def init_gqa(generator: torch.Generator, cfg: ModelConfig, *,
             device: torch.device | str, lead: tuple[int, ...] = ()) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = {"device": device, "lead": lead}
    return {
        "wq": init_linear(generator, d, h * hd, cfg.qkv_bias, cfg.dtype, **kw),
        "wk": init_linear(generator, d, kvh * hd, cfg.qkv_bias, cfg.dtype, **kw),
        "wv": init_linear(generator, d, kvh * hd, cfg.qkv_bias, cfg.dtype, **kw),
        "wo": init_linear(generator, h * hd, d, False, cfg.dtype, **kw),
    }


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None,
          scale: float | None = None) -> torch.Tensor:
    """q: [B,S,H,Dk]; k: [B,T,KVH,Dk]; v: [B,T,KVH,Dv];
    mask: [S,T] or [B,S,T] or None.  Logits and the weighted sum accumulate
    in fp32 over the operands' own values; probabilities are rounded to v's
    dtype before the sum, as in the JAX package."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    dv = v.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, s, kvh, h // kvh, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    if mask is not None:
        m = mask if mask.dim() == 2 else mask[:, None, None]
        logits = torch.where(m, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, s, h, dv).to(q.dtype)


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(p["wq"], x).reshape(b, s, h, hd)
    k = linear(p["wk"], x).reshape(b, s, kvh, hd)
    v = linear(p["wv"], x).reshape(b, s, kvh, hd)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, window: int | None = None,
                use_kernels: bool = False):
    """Returns (attn_out [B,S,d_model], (k_cache, v_cache) [B,S,KVH,D])."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    if use_kernels:
        from ..kernels.flash_attention import flash_attention
        out = flash_attention(q, k, v, causal=True, window=window or 0)
    elif s * s > CHUNK_THRESHOLD:
        raise _not_ported(f"prefill of {s} tokens (s·s > 2^22 runs the JAX "
                          "package's chunked_attention)", "A9")
    else:
        mask = causal_window_mask(positions[0], positions[0], window)
        out = _sdpa(q, k, v, mask)
    y = linear(p["wo"], out.reshape(b, s, cfg.n_heads * cfg.head_dim))
    return y, (k, v)


def _write_rows(cache: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                new: torch.Tensor) -> None:
    """cache[rows[i], cols[i]] = new[i], in place."""
    cache.index_put_((rows, cols), new.to(cache.dtype))


def gqa_decode(p: dict, x: torch.Tensor, cache_kv, pos: torch.Tensor,
               cfg: ModelConfig, window: int | None = None,
               use_kernels: bool = False):
    """One-token decode. x: [B,1,d]; cache_kv: (k, v) [B,T,KVH,D]; pos: [B].

    Writes the new K/V at ``pos`` in place and attends over positions
    <= pos (and within the window).  Cache length T is static."""
    k_cache, v_cache = cache_kv
    b, t = k_cache.shape[0], k_cache.shape[1]
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    rows = torch.arange(b, device=x.device)
    pos_l = pos.long()
    _write_rows(k_cache, rows, pos_l, k[:, 0])
    _write_rows(v_cache, rows, pos_l, v[:, 0])
    k_pos = torch.arange(t, device=x.device)[None, :]
    valid = k_pos <= pos_l[:, None]
    if window is not None:
        valid &= k_pos > (pos_l[:, None] - window)
    if use_kernels:
        from ..kernels.decode_attention import decode_attention
        out = decode_attention(q[:, 0], k_cache, v_cache, valid)[:, None]
    else:
        out = _sdpa(q, k_cache, v_cache, valid[:, None, :])
    y = linear(p["wo"], out.reshape(b, 1, cfg.n_heads * cfg.head_dim))
    return y, (k_cache, v_cache)


def gqa_paged_decode(p: dict, x: torch.Tensor, pages, block_tables: torch.Tensor,
                     pos: torch.Tensor, cfg: ModelConfig,
                     window: int | None = None, use_kernels: bool = False):
    """One-token decode against paged KV. x: [B,1,d]; pages: (k, v)
    [P,ps,KVH,D]; block_tables: [B,MAXP] int32; pos: [B].

    Writes the new K/V at ``(table[pos // ps], pos % ps)`` in place and
    attends positions ``[max(0, pos-window+1), pos]`` through the block
    table — there is no per-sequence dense slab."""
    k_pages, v_pages = pages
    ps = k_pages.shape[1]
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    rows = torch.arange(b, device=x.device)
    pos_l = pos.long()
    page = block_tables.long()[rows, pos_l // ps]
    off = pos_l % ps
    _write_rows(k_pages, page, off, k[:, 0])
    _write_rows(v_pages, page, off, v[:, 0])
    lengths = (pos_l + 1).to(torch.int32)
    starts = None
    if window is not None:
        starts = torch.clamp(pos_l - window + 1, min=0).to(torch.int32)
    if use_kernels:
        from ..kernels.paged_decode import paged_decode_attention
        out = paged_decode_attention(q[:, 0], k_pages, v_pages, block_tables,
                                     lengths, starts)
    else:
        from ..kernels.paged_decode.ref import paged_decode_attention_ref
        out = paged_decode_attention_ref(q[:, 0], k_pages, v_pages,
                                         block_tables, lengths, starts)
    y = linear(p["wo"], out.reshape(b, 1, cfg.n_heads * cfg.head_dim))
    return y, (k_pages, v_pages)


def _check_gqa(cfg: ModelConfig) -> None:
    if cfg.mla is not None:
        raise _not_ported(f"MLA attention ({cfg.name})", "A6")


def attn_prefill(p, x, cfg, positions, window=None, use_kernels=False):
    _check_gqa(cfg)
    return gqa_prefill(p, x, cfg, positions, window, use_kernels)


def attn_decode(p, x, cache, pos, cfg, window=None, use_kernels=False):
    _check_gqa(cfg)
    return gqa_decode(p, x, cache, pos, cfg, window, use_kernels)


def attn_paged_decode(p, x, pages, block_tables, pos, cfg, window=None,
                      use_kernels=False):
    _check_gqa(cfg)
    return gqa_paged_decode(p, x, pages, block_tables, pos, cfg, window,
                            use_kernels)


def init_cache(cfg: ModelConfig, batch: int, length: int, dtype=None, *,
               device: torch.device | str):
    """Empty per-layer KV cache (single layer); transformer stacks [L, ...]."""
    _check_gqa(cfg)
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype=None, *, device: torch.device | str):
    """Single-layer paged KV pages (page 0 reserved as the null page)."""
    _check_gqa(cfg)
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
