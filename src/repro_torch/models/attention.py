"""Attention: GQA (optionally sliding-window) and MLA (DeepSeek-style
latent attention), each with prefill, single-token decode against a dense
KV slab and decode against paged KV, plus the causal window mask and params
the dense export uses.

Kernel dispatch: with ``use_kernels=True`` GQA prefill calls the port's
flash attention kernel (with the layer's window; the JAX package's kernel
route drops it, ROADMAP C2), dense decode the decode-attention kernel and
paged decode the paged-decode kernel.  MLA, as in the JAX package, runs a
kernel on its paged decode only (the MLA form of the paged-decode kernel);
its prefill and dense decode are the plain latent attention, and
``use_kernels`` routes its two norms through the rmsnorm kernel.  Each
wrapper runs its plain version on CPU tensors.  Otherwise the plain math of
:func:`_sdpa` runs, and above ``CHUNK_THRESHOLD`` (s·s) the plain GQA
prefill and the MLA prefill on either route run
:func:`chunked_attention`, the JAX package's flash-structured forward, so
no ``[S, T]`` buffer is made for a long prompt.

Caches are written in place (``index_put_`` on the preallocated tensors)
and returned: a CUDA graph replays against fixed addresses, so the decode
step must update the static cache rather than build a new one.  MLA caches
the compressed latent: ``(c_kv [.., rank], k_rope [.., rope])`` per layer.

``chunked_attention`` has the reference's flash backward (a
``torch.autograd.Function``), so the training loss differentiates through
long prompts in O(S·chunk) memory.

The JAX package's performance flags (:mod:`repro_torch.flags`) act where
they act there: ``causal_skip`` skips the KV chunks that lie wholly in the
causal future or wholly below the window in ``chunked_attention``'s
forward (not in its backward, as there); ``window_slice_decode`` makes a
windowed GQA decode layer gather the ``window + 1`` slots it can attend
and a global one take the full masked path, both plain; ``kv_quant`` gives
the dense MLA decode cache an int8 latent with a per-token fp16 scale
(paged MLA pages stay in the model dtype).  The cache-update mode changes
nothing here: the new slot is written in place under either value.

Under sharding rules (:mod:`repro_torch.utils.sharding_ctx`) the
activations are annotated at the reference's sites, the head splits go
through ``shard_split`` and the dense-slab writes through ``write_slots``,
so ``DTensor`` params, inputs and caches run the same code.  The module's
``_CHUNK_OVERRIDE = "single"`` (the roofline's hook, as the reference's)
makes :func:`chunked_attention` take the whole sequence as one chunk.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Shard

from ..configs.base import ModelConfig
from ..flags import causal_skip, kv_quant, window_slice_decode
from ..utils import shard
from ..utils.sharding_ctx import (on_local_shards, shard_merge, shard_split,
                                  write_slots)
from .layers import (apply_norm, apply_rope, init_linear, init_norm, linear,
                     matmul, yarn_mscale)

NEG_INF = -1e30
# s·t above which the plain path never makes an [S, T] buffer and runs
# chunked_attention instead
CHUNK_THRESHOLD = 1 << 22
# roofline hook: "single" forces one chunk in chunked_attention (the
# roofline's one-block count, launch/roofline.py); None = production chunks
_CHUNK_OVERRIDE: str | None = None


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: int | None) -> torch.Tensor:
    """[qs, ks] boolean: causal AND within window (window=None → pure causal)."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


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


def _per_shard(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether attention over ``DTensor``s runs on local shards: always,
    but for a decode over a cache whose positions are split while the
    queries' are not.  There each rank's keys hold a share of every
    query's softmax, which ``DTensor``'s own propagation reduces across
    ranks; making the positions whole would move the whole cache."""
    return isinstance(q, DTensor) and not (
        isinstance(k, DTensor) and Shard(1) in k.placements
        and Shard(1) not in q.placements)


def _attend_on_shards(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """``fn(q, k, v, mask)``, an attention ``[B,S,H,Dk]``, ``[B,T,KVH,Dk]``,
    ``[B,T,KVH,Dv]`` → ``[B,S,H,Dv]``, on each rank's shards of
    ``DTensor`` operands: it is independent per (row, head), so the batch
    and the heads keep their splits and the rest is made whole, a split
    sequence too (the softmax spans it).  K/V split their heads as the
    queries do, or stay whole when there is one KV head (MLA's latent,
    which every query head reads)."""
    g = "h" if k.shape[2] > 1 else "g"
    m = "" if mask is None else ("st" if mask.dim() == 2 else "bst")
    return on_local_shards(fn, f"bshd,bt{g}d,bt{g}e,{m}->bshe", q, k, v,
                           mask, split="bh")


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None,
          scale: float | None = None) -> torch.Tensor:
    """q: [B,S,H,Dk]; k: [B,T,KVH,Dk]; v: [B,T,KVH,Dv];
    mask: [S,T] or [B,S,T] or None.  Logits and the weighted sum accumulate
    in fp32 over the operands' own values; probabilities are rounded to v's
    dtype before the sum, as in the JAX package.  ``DTensor`` operands are
    attended shard by shard (``on_local_shards``)."""
    if _per_shard(q, k):
        return _attend_on_shards(
            lambda q, k, v, m: _sdpa(q, k, v, m, scale), q, k, v, mask)
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


# -- chunked flash-structured attention (plain torch, long prompts) ----------

def _chunk_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: float) -> torch.Tensor:
    """[qc, kc] boolean from absolute positions: causal, and within
    ``window`` when it is > 0 (compared in fp32, as the JAX package
    compares)."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        mask = mask & (k_pos[None, :].float()
                       > q_pos[:, None].float() - window)
    return mask


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: float, *, causal: bool, scale: float, qc: int,
               kc: int):
    """Online-softmax forward over ``q [B,S,H,Dk]``, ``k [B,T,KVH,Dk]``,
    ``v [B,T,KVH,Dv]`` in chunks of ``qc`` queries and ``kc`` keys (the
    last of each may be short) → (out [B,S,H,Dv] in q's dtype, lse [B,H,S]
    fp32).  The query heads are grouped ``[KVH, G]`` over their shared KV
    head, so no repeated K/V is made; logits accumulate in fp32 over the
    operands' own values, and the unnormalised probabilities are rounded
    to v's dtype before the PV product, as the JAX package's ``_flash_fwd``
    does (ROADMAP C8).  Under the ``causal_skip`` flag a causal forward
    skips each key chunk the query chunk cannot see: chunk positions are
    Python ints, so the skip is decided on the host and a CUDA graph
    records it with no sync."""
    b, s, h, dk = q.shape
    t, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    dev = q.device
    skip = causal and causal_skip()
    outs, lses = [], []
    for q0 in range(0, s, qc):
        n = min(qc, s - q0)
        qblk = q[:, q0:q0 + n].reshape(b, n, kvh, g, dk).float()
        q_pos = torch.arange(q0, q0 + n, device=dev)
        m = torch.full((b, kvh, g, n), NEG_INF, device=dev)
        l = torch.zeros((b, kvh, g, n), device=dev)
        acc = torch.zeros((b, kvh, g, n, dv), device=dev)
        pad = 0
        for k0 in range(0, t, kc):
            if skip and (k0 > q0 + qc - 1 or (
                    window > 0 and k0 + kc - 1 < q0 - window + 1)):
                # wholly in the causal future of the (padded) query chunk,
                # or wholly below its window: the JAX package's test on
                # chunk multiples, so both skip the same chunks
                continue
            if k0 + kc > t:
                pad = k0 + kc - t
            k_pos = torch.arange(k0, min(k0 + kc, t), device=dev)
            logits = torch.einsum("bckgd,btkd->bkgct", qblk,
                                  k[:, k0:k0 + kc].float()) * scale
            logits = shard(logits, "batch", "heads", None, None, None)
            mask = _chunk_mask(q_pos, k_pos, causal, window)
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bkgct,btkd->bkgcd", p.to(v.dtype).float(),
                              v[:, k0:k0 + kc].float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        # a row that sees no key (its window starting past the last key)
        # weighs every key of the chunks it computed alike; the JAX package
        # pads K/V to a chunk multiple, so it divides by the padded length
        # when the short last chunk was computed
        l = torch.where(m == NEG_INF, l + pad, l)
        l_safe = l.clamp_min(1e-30)
        out = acc / l_safe[..., None]                     # [b,kvh,g,n,dv]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, n, h, dv)
                    .to(q.dtype))
        lses.append((m + torch.log(l_safe)).reshape(b, h, n))
    return torch.cat(outs, 1), torch.cat(lses, 2)


def _flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
               window: float, *, causal: bool, scale: float, qc: int,
               kc: int):
    """FlashAttention backward, the JAX package's ``_flash_bwd_impl``:
    ``D = rowsum(dout ⊙ out)``, then per (query chunk, key chunk) p is
    recomputed from the saved ``lse`` and the ``ds``, ``dv``, ``dk`` and
    ``dq`` contractions run in fp32, with p rounded to dout's dtype before
    the dv product and ds to q's / k's before the dk / dq products, where
    the reference rounds them.  The query heads stay grouped ``[KVH, G]``,
    so the dk and dv contractions fold them onto their KV head (GQA, and
    MLA's heads over one latent head).  Memory: fp32 dq, dk, dv and one
    chunk pair's ``[B,H,qc,kc]`` buffers, O(S·chunk).  Each chunk's grads
    are summed out of place in chunk order (a ``DTensor`` cannot add in
    place into a plain zero buffer).
    → (dq, dk, dv) in q's, k's and v's dtypes."""
    b, s, h, dk = q.shape
    t, kvh = k.shape[1], k.shape[2]
    dv_dim = v.shape[-1]
    g = h // kvh
    dev = q.device
    dsum = (dout.float() * out.float()).sum(-1)            # [b,s,h]
    dq_rows: list = []                   # per query chunk
    dk_cols: dict[int, torch.Tensor] = {}  # per key chunk, in chunk order
    dv_cols: dict[int, torch.Tensor] = {}
    for q0 in range(0, s, qc):
        n = min(qc, s - q0)
        qblk = q[:, q0:q0 + n].reshape(b, n, kvh, g, dk)
        doblk = dout[:, q0:q0 + n].reshape(b, n, kvh, g, dv_dim)
        lse_i = lse[:, :, q0:q0 + n].reshape(b, kvh, g, n, 1)
        dsum_i = dsum[:, q0:q0 + n].reshape(b, n, kvh, g).permute(
            0, 2, 3, 1)[..., None]                          # [b,kvh,g,n,1]
        q_pos = torch.arange(q0, q0 + n, device=dev)
        qf, dof = qblk.float(), doblk.float()
        dq_i = None
        for k0 in range(0, t, kc):
            k_pos = torch.arange(k0, min(k0 + kc, t), device=dev)
            kf = k[:, k0:k0 + kc].float()
            logits = torch.einsum("bckgd,btkd->bkgct", qf, kf) * scale
            logits = shard(logits, "batch", "heads", None, None, None)
            mask = _chunk_mask(q_pos, k_pos, causal, window)
            logits = torch.where(mask, logits, NEG_INF)
            p = torch.exp(logits - lse_i)                   # [b,kvh,g,n,kc]
            dp = torch.einsum("bckgd,btkd->bkgct", dof,
                              v[:, k0:k0 + kc].float())
            ds = p * (dp - dsum_i) * scale
            dv_j = torch.einsum("bkgct,bckgd->btkd",
                                p.to(dout.dtype).float(), dof)
            dk_j = torch.einsum("bkgct,bckgd->btkd", ds.to(q.dtype).float(),
                                qf)
            dq_j = torch.einsum("bkgct,btkd->bckgd", ds.to(k.dtype).float(),
                                kf)
            dv_cols[k0] = dv_j if k0 not in dv_cols else dv_cols[k0] + dv_j
            dk_cols[k0] = dk_j if k0 not in dk_cols else dk_cols[k0] + dk_j
            dq_i = dq_j if dq_i is None else dq_i + dq_j
        dq_rows.append(dq_i)
    dq = torch.cat(dq_rows, 1)
    dk_acc = torch.cat(list(dk_cols.values()), 1)
    dv_acc = torch.cat(list(dv_cols.values()), 1)
    return (dq.reshape(b, s, h, dk).to(q.dtype), dk_acc.to(k.dtype),
            dv_acc.to(v.dtype))


class _ChunkedAttention(torch.autograd.Function):
    """:func:`_flash_fwd` forward saving ``out`` and ``lse``,
    :func:`_flash_bwd` backward: the reference's flash custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, window: float, causal: bool, scale: float,
                qc: int, kc: int):
        out, lse = _flash_fwd(q, k, v, window, causal=causal, scale=scale,
                              qc=qc, kc=kc)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (window, causal, scale, qc, kc)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        window, causal, scale, qc, kc = ctx.args
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout.contiguous(), window,
                                causal=causal, scale=scale, qc=qc, kc=kc)
        return dq, dk, dv, None, None, None, None, None


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      scale: float | None = None, q_chunk: int = 2048,
                      kv_chunk: int = 2048) -> torch.Tensor:
    """The JAX package's flash-structured attention in plain torch, with its
    flash backward: O(S·chunk) memory forward and backward, the whole
    ``[S, T]`` logits never made (p is recomputed from the saved
    log-sum-exp).

    q: [B,S,H,Dk]; k: [B,T,KVH,Dk]; v: [B,T,KVH,Dv] → [B,S,H,Dv].  The
    last Q and KV chunks are short where S, T are no chunk multiple;
    ``window`` <= 0 or >= 2^29 (or None) disables the window."""
    if _per_shard(q, k):
        return _attend_on_shards(
            lambda q, k, v, _: chunked_attention(
                q, k, v, causal=causal, window=window, scale=scale,
                q_chunk=q_chunk, kv_chunk=kv_chunk), q, k, v)
    s, dk = q.shape[1], q.shape[-1]
    t = k.shape[1]
    scale = dk ** -0.5 if scale is None else scale
    if _CHUNK_OVERRIDE == "single":
        q_chunk, kv_chunk = s, t
    w = 0.0 if window is None else float(window)
    if w >= float(1 << 29):
        w = 0.0
    return _ChunkedAttention.apply(q, k, v, w, causal, float(scale),
                                   min(q_chunk, s), min(kv_chunk, t))


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = shard_split(linear(p["wq"], x), (b, s, h, hd),
                    "batch", "seq", "heads", None)
    k = shard_split(linear(p["wk"], x), (b, s, kvh, hd),
                    "batch", "seq", "kv_heads", None)
    v = shard_split(linear(p["wv"], x), (b, s, kvh, hd),
                    "batch", "seq", "kv_heads", None)
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
        out = chunked_attention(q, k, v, causal=True, window=window)
    else:
        mask = causal_window_mask(positions[0], positions[0], window)
        out = _sdpa(q, k, v, mask)
    y = linear(p["wo"], shard_merge(out, (b, s, cfg.n_heads * cfg.head_dim),
                                     "batch", "seq", "heads"))
    return shard(y, "batch", "seq", "embed"), (k, v)


def _write_rows(cache: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                new: torch.Tensor) -> None:
    """cache[rows[i], cols[i]] = new[i], in place."""
    cache.index_put_((rows, cols), new.to(cache.dtype))


def gqa_decode(p: dict, x: torch.Tensor, cache_kv, pos: torch.Tensor,
               cfg: ModelConfig, window: int | None = None,
               use_kernels: bool = False):
    """One-token decode. x: [B,1,d]; cache_kv: (k, v) [B,T,KVH,D]; pos: [B].

    Writes the new K/V at ``pos`` in place and attends over positions
    <= pos (and within the window).  Cache length T is static.

    Under the ``window_slice_decode`` flag, when the config's window ``w``
    leaves ``w + 1 + meta_tokens < T``, the JAX package's ``lax.cond``
    becomes a branch on the layer: a windowed layer gathers the ``w + 1``
    slots from ``clip(pos - w, 0, T - w - 1)`` of each row and a global
    layer attends the whole cache, both by plain :func:`_sdpa` on either
    route, as there.  The gather's indices stay on the card, so the step
    still records into a CUDA graph."""
    k_cache, v_cache = cache_kv
    b, t = k_cache.shape[0], k_cache.shape[1]
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    rows = torch.arange(b, device=x.device)
    pos_l = pos.long()
    write_slots(k_cache, pos_l, k[:, 0])
    write_slots(v_cache, pos_l, v[:, 0])
    w = cfg.window
    if (window_slice_decode() and w is not None
            and w + 1 + cfg.meta_tokens < t):
        if window is None:                  # a global layer
            valid = torch.arange(t, device=x.device)[None, :] <= pos_l[:, None]
            out = _sdpa(q, k_cache, v_cache, valid[:, None, :])
        else:
            start = torch.clamp(pos_l - w, 0, t - w - 1)
            k_pos = start[:, None] + torch.arange(w + 1, device=x.device)
            ok = (k_pos <= pos_l[:, None]) & (k_pos > pos_l[:, None] - w)
            out = _sdpa(q, k_cache[rows[:, None], k_pos],
                        v_cache[rows[:, None], k_pos], ok[:, None, :])
        y = linear(p["wo"], shard_merge(
            out, (b, 1, cfg.n_heads * cfg.head_dim), "batch", "seq", "heads"))
        return y, (k_cache, v_cache)
    k_pos = torch.arange(t, device=x.device)[None, :]
    valid = k_pos <= pos_l[:, None]
    if window is not None:
        valid &= k_pos > (pos_l[:, None] - window)
    if use_kernels:
        from ..kernels.decode_attention import decode_attention
        out = decode_attention(q[:, 0], k_cache, v_cache, valid)[:, None]
    else:
        out = _sdpa(q, k_cache, v_cache, valid[:, None, :])
    y = linear(p["wo"], shard_merge(
        out, (b, 1, cfg.n_heads * cfg.head_dim), "batch", "seq", "heads"))
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
    y = linear(p["wo"], shard_merge(
        out, (b, 1, cfg.n_heads * cfg.head_dim), "batch", "seq", "heads"))
    return y, (k_pages, v_pages)


# -- MLA (DeepSeek-V3) ----------------------------------------------------------

def init_mla(generator: torch.Generator, cfg: ModelConfig, *,
             device: torch.device | str, lead: tuple[int, ...] = ()) -> dict:
    """The JAX package's ``init_mla`` tree: low-rank query and latent KV
    projections, their norms, and the per-head ``wk_b``/``wv_b``
    up-projections."""
    m = cfg.mla
    d, h, dt = cfg.d_model, cfg.n_heads, cfg.dtype
    kw = {"device": device, "lead": lead}
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": init_linear(generator, d, m.q_lora_rank, False, dt, **kw),
        "q_norm": init_norm(m.q_lora_rank, "rmsnorm", dt, **kw),
        "wq_b": init_linear(generator, m.q_lora_rank, h * qk_head, False, dt,
                            **kw),
        "wkv_a": init_linear(generator, d,
                             m.kv_lora_rank + m.qk_rope_head_dim, False, dt,
                             **kw),
        "kv_norm": init_norm(m.kv_lora_rank, "rmsnorm", dt, **kw),
        "wk_b": init_linear(generator, m.kv_lora_rank,
                            h * m.qk_nope_head_dim, False, dt, **kw),
        "wv_b": init_linear(generator, m.kv_lora_rank, h * m.v_head_dim,
                            False, dt, **kw),
        "wo": init_linear(generator, h * m.v_head_dim, d, False, dt, **kw),
    }


def _mla_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor, use_kernels: bool):
    """The shared projections → (q_nope, q_rope, c_kv, k_rope), RoPE on the
    query's rope part and on the one shared rope key."""
    m = cfg.mla
    b, s, _ = x.shape
    nope, rank = m.qk_nope_head_dim, m.kv_lora_rank
    cq = apply_norm(p["q_norm"], linear(p["wq_a"], x), "rmsnorm", use_kernels)
    q = linear(p["wq_b"], cq).reshape(b, s, cfg.n_heads,
                                      nope + m.qk_rope_head_dim)
    kv = linear(p["wkv_a"], x)
    c_kv = apply_norm(p["kv_norm"], kv[..., :rank].contiguous(), "rmsnorm",
                      use_kernels)                       # [B,S,rank]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta,
                        m.rope_scaling)
    k_rope = apply_rope(kv[:, :, None, rank:], positions, cfg.rope_theta,
                        m.rope_scaling)[:, :, 0]
    return q[..., :nope], q_rope, c_kv, k_rope


def _wk_b(p: dict, cfg: ModelConfig) -> torch.Tensor:
    m = cfg.mla
    return p["wk_b"]["w"].reshape(m.kv_lora_rank, cfg.n_heads,
                                  m.qk_nope_head_dim)


def value_up(lat: torch.Tensor, wv_b: torch.Tensor,
             v_head: int) -> torch.Tensor:
    """Per-head value up-projection of the latent output ``[.., H, rank]``
    through ``wv_b`` ``[rank, H·v_head]`` (fp32 accumulation, one rounding)
    → ``[.., H·v_head]``."""
    h, rank = lat.shape[-2:]
    wv = wv_b.reshape(rank, h, v_head).permute(1, 0, 2)       # [H,rank,v]
    out = matmul(lat.reshape(-1, h, rank).transpose(0, 1), wv)
    return out.transpose(0, 1).reshape(*lat.shape[:-2], h * v_head)


def _mla_out(p: dict, lat: torch.Tensor, cfg: ModelConfig,
             dtype: torch.dtype | None = None) -> torch.Tensor:
    """``wo(value_up(lat))``; with ``dtype`` (the latent cache's, when it
    differs from the model's: the int8 cache's bf16 dequantised latent in
    an fp32 model) the value-up output and the result are rounded to it,
    where the JAX package casts them to the latent's dtype."""
    up = value_up(lat, p["wv_b"]["w"], cfg.mla.v_head_dim)
    if dtype is None or dtype == up.dtype:
        return linear(p["wo"], up)
    return linear(p["wo"], up.to(dtype).to(up.dtype)).to(dtype)


def _mla_scale(cfg: ModelConfig) -> float:
    """The softmax scale: qk_head^-0.5, times mscale(factor,
    mscale_all_dim)² under YaRN (DeepSeek-V3's MLA)."""
    m = cfg.mla
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    y = m.rope_scaling
    if y is not None and y.mscale_all_dim:
        scale *= yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return scale


def mla_attention(p: dict, q_nope: torch.Tensor, q_rope: torch.Tensor,
                  c_kv: torch.Tensor, k_rope: torch.Tensor, cfg: ModelConfig,
                  mask: torch.Tensor | None = None,
                  chunked: bool = False) -> torch.Tensor:
    """Latent attention in the absorbed form: MLA is GQA with ONE shared
    latent KV head.  ``q_lat = q_nope · W_kbᵀ`` per head, then
    ``[q_lat ‖ q_rope]`` attends ``[c_kv ‖ k_rope]`` with ``V = c_kv``
    (Dk = rank + rope, Dv = rank) and the output goes up through ``wv_b``
    and ``wo``.  ``chunked`` runs the causal :func:`chunked_attention`
    instead of ``_sdpa`` under ``mask``."""
    from ..kernels.paged_decode.ref import absorb_query
    q_lat = absorb_query(q_nope, _wk_b(p, cfg), matmul)
    q_cat = torch.cat([q_lat, q_rope], dim=-1)            # [B,S,H,rank+rope]
    k_cat = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]
    if chunked:
        lat = chunked_attention(q_cat, k_cat, c_kv[:, :, None, :],
                                causal=True, scale=_mla_scale(cfg))
    else:
        lat = _sdpa(q_cat, k_cat, c_kv[:, :, None, :], mask,
                    scale=_mla_scale(cfg))                # [B,S,H,rank]
    return _mla_out(p, lat, cfg, c_kv.dtype)


def mla_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, use_kernels: bool = False):
    """Returns (attn_out [B,S,d_model], (c_kv [B,S,rank], k_rope
    [B,S,rope])).  Plain latent attention on either route, as in the JAX
    package: chunked above ``CHUNK_THRESHOLD``."""
    s = x.shape[1]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions, use_kernels)
    if s * s > CHUNK_THRESHOLD:
        y = mla_attention(p, q_nope, q_rope, c_kv, k_rope, cfg, chunked=True)
    else:
        mask = causal_window_mask(positions[0], positions[0], None)
        y = mla_attention(p, q_nope, q_rope, c_kv, k_rope, cfg, mask=mask)
    return shard(y, "batch", "seq", "embed"), (c_kv, k_rope)


def mla_decode(p: dict, x: torch.Tensor, cache, pos: torch.Tensor,
               cfg: ModelConfig, use_kernels: bool = False):
    """One-token decode against the dense latent slab ``(c_kv [B,T,rank],
    k_rope [B,T,rope])``: writes the new latent at ``pos`` in place and
    attends positions <= pos.

    Under the ``kv_quant`` flag the slab is the triple ``(int8 [B,T,rank],
    fp16 scale [B,T], k_rope)``, as the JAX package's: the new latent is
    quantised with its own absmax scale, all three leaves are written, and
    the latent is dequantised as ``int8.bf16 * scale.bf16`` (a bf16 product
    whatever the model's dtype)."""
    quant = kv_quant() and len(cache) == 3
    if quant:
        c_q, c_scale, r_cache = cache
    else:
        c_cache, r_cache = cache
    b, t = r_cache.shape[0], r_cache.shape[1]
    q_nope, q_rope, c_new, r_new = _mla_qkv(p, x, cfg, pos[:, None],
                                            use_kernels)
    pos_l = pos.long()
    if quant:
        c1 = c_new[:, 0]
        scale = c1.abs().amax(-1).clamp_min(1e-6)
        write_slots(c_q, pos_l, torch.clamp(
            torch.round(c1 / scale[:, None] * 127.0), -127, 127).to(
                torch.int8))
        write_slots(c_scale, pos_l, (scale / 127.0).to(torch.float16))
        c_cache = (c_q.to(torch.bfloat16)
                   * c_scale[..., None].to(torch.bfloat16))
    else:
        write_slots(c_cache, pos_l, c_new[:, 0])
    write_slots(r_cache, pos_l, r_new[:, 0])
    valid = torch.arange(t, device=x.device)[None, :] <= pos_l[:, None]
    y = mla_attention(p, q_nope, q_rope, c_cache, r_cache, cfg,
                      mask=valid[:, None, :])
    return y, cache


def mla_paged_decode(p: dict, x: torch.Tensor, pages,
                     block_tables: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig, use_kernels: bool = False):
    """One-token decode over latent pages (ckv ``[P,ps,rank]``, kpe
    ``[P,ps,rope]``): the new latent is written at ``(table[pos // ps],
    pos % ps)`` in place; the absorbed attention runs through the block
    table (the MLA form of the paged-decode kernel with ``use_kernels``)."""
    from ..kernels.paged_decode import paged_mla_decode_attention
    from ..kernels.paged_decode.ref import paged_mla_decode_attention_ref
    ckv_pages, kpe_pages = pages
    ps = ckv_pages.shape[1]
    b = x.shape[0]
    q_nope, q_rope, c_new, r_new = _mla_qkv(p, x, cfg, pos[:, None],
                                            use_kernels)
    rows = torch.arange(b, device=x.device)
    pos_l = pos.long()
    page = block_tables.long()[rows, pos_l // ps]
    off = pos_l % ps
    _write_rows(ckv_pages, page, off, c_new[:, 0])
    _write_rows(kpe_pages, page, off, r_new[:, 0])
    lengths = (pos_l + 1).to(torch.int32)
    attend = (paged_mla_decode_attention if use_kernels
              else paged_mla_decode_attention_ref)
    lat = attend(q_nope[:, 0], q_rope[:, 0], ckv_pages, kpe_pages,
                 _wk_b(p, cfg), block_tables, lengths, _mla_scale(cfg))
    y = _mla_out(p, lat[:, None], cfg)
    return y, (ckv_pages, kpe_pages)


# -- dispatch -----------------------------------------------------------------

def init_attention(generator: torch.Generator, cfg: ModelConfig, *,
                   device: torch.device | str,
                   lead: tuple[int, ...] = ()) -> dict:
    init = init_mla if cfg.mla is not None else init_gqa
    return init(generator, cfg, device=device, lead=lead)


def attn_prefill(p, x, cfg, positions, window=None, use_kernels=False):
    if cfg.mla is not None:
        return mla_prefill(p, x, cfg, positions, use_kernels)
    return gqa_prefill(p, x, cfg, positions, window, use_kernels)


def attn_decode(p, x, cache, pos, cfg, window=None, use_kernels=False):
    if cfg.mla is not None:
        return mla_decode(p, x, cache, pos, cfg, use_kernels)
    return gqa_decode(p, x, cache, pos, cfg, window, use_kernels)


def attn_paged_decode(p, x, pages, block_tables, pos, cfg, window=None,
                      use_kernels=False):
    if cfg.mla is not None:
        return mla_paged_decode(p, x, pages, block_tables, pos, cfg,
                                use_kernels)
    return gqa_paged_decode(p, x, pages, block_tables, pos, cfg, window,
                            use_kernels)


def _cache_shapes(cfg: ModelConfig, lead: tuple[int, int]):
    """(shape of the first leaf, shape of the second) per layer: GQA's
    ``(k, v)`` ``[.., KVH, D]``, MLA's latent ``(c_kv [.., rank], k_rope
    [.., rope])``."""
    if cfg.mla is not None:
        return (lead + (cfg.mla.kv_lora_rank,),
                lead + (cfg.mla.qk_rope_head_dim,))
    kv = lead + (cfg.n_kv_heads, cfg.head_dim)
    return kv, kv


def init_cache(cfg: ModelConfig, batch: int, length: int, dtype=None, *,
               device: torch.device | str):
    """Empty per-layer KV cache (single layer); transformer stacks [L, ...].
    Under the ``kv_quant`` flag an MLA cache is ``(int8 latent, fp16
    per-token scale [batch, length], k_rope)``."""
    dtype = dtype or cfg.dtype
    c_shape, r_shape = _cache_shapes(cfg, (batch, length))
    if cfg.mla is not None and kv_quant():
        return (torch.zeros(c_shape, dtype=torch.int8, device=device),
                torch.zeros((batch, length), dtype=torch.float16,
                            device=device),
                torch.zeros(r_shape, dtype=dtype, device=device))
    return (torch.zeros(c_shape, dtype=dtype, device=device),
            torch.zeros(r_shape, dtype=dtype, device=device))


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype=None, *, device: torch.device | str):
    """Single-layer paged KV pages (page 0 reserved as the null page); MLA
    pages the compressed latent, in the model's dtype under ``kv_quant``
    too (the engine keeps that flag off the paged path)."""
    dtype = dtype or cfg.dtype
    return tuple(torch.zeros(shape, dtype=dtype, device=device)
                 for shape in _cache_shapes(cfg, (num_pages, page_size)))
