"""Transformer assembly of the decoder LM: parameter init, the prefill
forward and the single-token decode steps (dense slab and paged KV).

The tree layout is the JAX package's ``init_lm``: ``{"embed": {"table"},
"stacks": [per-stack params with leading dim L], "final_norm": {"scale"}}``
(plus ``"head"`` when embeddings are untied), so a reference param tree
converted by :mod:`repro_torch.bridge` and this init are interchangeable.
Where the JAX package scans a stack with ``jax.lax.scan``, the port loops
over the layer index in Python, with each layer's attention window an int
(0 = none).  Stacks are of one block kind each: ``dense`` (GQA + MLP),
``dense_prefix`` and ``moe`` (the MoE family: its first layers keep a wide
dense MLP, the rest route to experts), ``hybrid`` (Hymba: attention and a
Mamba head in parallel on the same normed input, their outputs averaged)
and ``rwkv`` (RWKV-6 time and channel mix).  Attention is GQA, or MLA
(DeepSeek-V3) when the config has one.  Caches are stacked ``[L, ...]`` per
stack as there — ``(k, v)`` for GQA stacks, the latent ``(c_kv, k_rope)``
for MLA stacks, ``{kv, mamba_conv, mamba_h}`` for hybrid stacks, ``{tm_x,
tm_s, cm_x}`` recurrent state for RWKV — and decode writes them in place.
A config with meta tokens (Hymba) gets the reference's learned ``meta``
rows, prepended to every prompt; decode positions are offset by their
count.  An MTP config gets the reference's ``mtp`` subtree (projection,
one block, norm); nothing at serving reads it, and its loss is training's.
A vision-language config (llava) gets the reference's ``frontend``
projector (two linears with a tanh GELU between): prefill takes
precomputed patch embeddings ``extra_embeds`` and prepends their
projection to the text, positions running over ``[image ‖ text]``.
Encoder-decoder models live in :mod:`.encdec` and raise here.
Training: :func:`lm_loss` is the reference's next-token cross-entropy plus
0.01 times the MoE layers' load-balancing loss, plus 0.3 times the MTP
head's loss for MTP configs; ``remat`` recomputes each layer in the
backward, and the ``chunked_ce`` flag takes the cross-entropy a sequence
chunk at a time (:func:`.losses.chunked_softmax_xent`).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from ..flags import chunked_ce
from .attention import (attn_decode, attn_paged_decode, attn_prefill,
                        init_attention, init_cache, init_paged_cache)
from .ffn import ffn, init_ffn, init_mlp, mlp
from .layers import (apply_norm, check_device, embed, gelu, init_embedding,
                     init_linear, init_norm, linear, unembed)
from ..utils import shard
from ..utils.sharding_ctx import copy_into, whole_dim
from .losses import chunked_softmax_xent, softmax_xent
from .ssm import (init_mamba, init_rwkv_channel_mix, init_rwkv_time_mix,
                  mamba_seq, mamba_state_init, rwkv_channel_mix,
                  rwkv_state_init, rwkv_time_mix_seq)

MTP_LOSS_WEIGHT = 0.3


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, int]]:
    """[(kind, n_layers)] groups executed in order (dense-prefix before MoE)."""
    if cfg.family == "ssm":
        return [("rwkv", cfg.n_layers)]
    if cfg.family == "hybrid":
        return [("hybrid", cfg.n_layers)]
    if cfg.moe is not None:
        prefix = cfg_dense_prefix(cfg)
        groups = []
        if prefix:
            groups.append(("dense_prefix", prefix))
        groups.append(("moe", cfg.n_layers - prefix))
        return groups
    return [("dense", cfg.n_layers)]


def cfg_dense_prefix(cfg: ModelConfig) -> int:
    """The MoE family's leading dense layers, ``moe.dense_prefix``; at
    least one layer stays MoE."""
    prefix = cfg.moe.dense_prefix if cfg.moe is not None else 0
    return min(prefix, max(cfg.n_layers - 1, 0))


def window_for_layer(cfg: ModelConfig, global_index: int) -> int:
    """0 means no window (full attention)."""
    if cfg.window is None:
        return 0
    if global_index in cfg.global_layers:
        return 0
    return cfg.window


def stack_meta(cfg: ModelConfig) -> list[tuple[str, int, tuple[int, ...]]]:
    """Static metadata per stack: (kind, n_layers, window_sizes)."""
    out = []
    base = 0
    for kind, n in layer_kinds(cfg):
        windows = tuple(window_for_layer(cfg, base + i) for i in range(n))
        out.append((kind, n, windows))
        base += n
    return out


def init_block(generator: torch.Generator, cfg: ModelConfig, layer_kind: str,
               *, device: torch.device | str,
               lead: tuple[int, ...] = ()) -> dict:
    """Params of ``lead`` stacked blocks of ``layer_kind`` (dense,
    dense_prefix, moe, hybrid or rwkv)."""
    kw = {"device": device, "lead": lead}
    if layer_kind == "rwkv":
        return {
            "norm1": init_norm(cfg.d_model, cfg.norm, cfg.dtype, **kw),
            "time_mix": init_rwkv_time_mix(generator, cfg, **kw),
            "norm2": init_norm(cfg.d_model, cfg.norm, cfg.dtype, **kw),
            "channel_mix": init_rwkv_channel_mix(generator, cfg, **kw),
        }
    p = {
        "norm1": init_norm(cfg.d_model, cfg.norm, cfg.dtype, **kw),
        "attn": init_attention(generator, cfg, **kw),
        "norm2": init_norm(cfg.d_model, cfg.norm, cfg.dtype, **kw),
        "ffn": (init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act,
                         cfg.dtype, **kw) if layer_kind == "dense_prefix"
                else init_ffn(generator, cfg, **kw)),
    }
    if layer_kind == "hybrid":
        p["mamba"] = init_mamba(generator, cfg, **kw)
    return p


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device: torch.device | str = "cuda") -> dict:
    """Random LM params on ``device`` drawn from ``generator`` (which must
    live on that device).  Scales follow the JAX package: linear weights
    ``d_in**-0.5``, embeddings ``0.02``, zero biases, unit norms."""
    device = check_device(device)
    _check_supported(cfg)
    p = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                cfg.dtype, device=device),
        "stacks": [init_block(generator, cfg, kind, device=device, lead=(n,))
                   for kind, n, _ in stack_meta(cfg)],
        "final_norm": init_norm(cfg.d_model, cfg.norm, cfg.dtype,
                                device=device),
    }
    if not cfg.tie_embeddings:
        p["head"] = init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                   cfg.dtype, device=device)
    if cfg.meta_tokens:
        p["meta"] = init_embedding(generator, cfg.meta_tokens, cfg.d_model,
                                   cfg.dtype, device=device)["table"]
    if cfg.mtp_heads:
        # DeepSeek-V3's multi-token-prediction head, as the reference builds
        # it: [h ‖ embed(next)] projected back to d, one block, a norm
        d = cfg.d_model
        p["mtp"] = {
            "proj": init_linear(generator, 2 * d, d, False, cfg.dtype,
                                device=device),
            "block": init_block(generator, cfg,
                                "dense" if cfg.moe is None else "moe",
                                device=device),
            "norm": init_norm(d, cfg.norm, cfg.dtype, device=device),
        }
    if cfg.frontend is not None:
        # llava's 2-layer projector from the patch features to d_model
        fe = cfg.frontend
        p["frontend"] = {
            "proj1": init_linear(generator, fe.feat_dim, cfg.d_model, True,
                                 cfg.dtype, device=device),
            "proj2": init_linear(generator, cfg.d_model, cfg.d_model, True,
                                 cfg.dtype, device=device),
        }
    return p


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder model: its stack is "
            "models/encdec.py (Model routes it there)")


def layer_params(tree: Any, li: int) -> Any:
    """Layer ``li`` of a stacked ``[L, ...]`` param tree (views; a
    ``DTensor`` stack split over L is made whole along it first)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, li) for k, v in tree.items()}
    return whole_dim(tree, 0)[li]


def layer_list(tree: Any, n: int) -> list:
    """The ``n`` layers of a stacked ``[L, ...]`` param tree as views, one
    ``torch.unbind`` a leaf: under autograd each leaf's layer grads are
    stacked once, where indexing layer by layer would scatter every
    layer's grad into a zero tensor of the whole stack and add the L of
    them."""
    if isinstance(tree, dict):
        parts = {k: layer_list(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(whole_dim(tree, 0), 0))


def _window(w: int) -> int | None:
    return w if w > 0 else None


# ============================ block =========================================

def _ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, use_kernels: bool,
         layer_kind: str, generator: torch.Generator | None = None):
    """→ (out, aux loss or None): the MoE layer's load-balancing loss."""
    if layer_kind == "dense_prefix":
        return mlp(p, x, cfg.act), None
    out, aux = ffn(p, x, cfg, generator, use_kernels)
    return out, aux.get("aux_loss")


def _rwkv_block(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig,
                use_kernels: bool):
    """RWKV-6 block from ``state`` → (x', (tm_x, tm_s, cm_x))."""
    y, (tm_x, tm_s) = rwkv_time_mix_seq(
        p["time_mix"], apply_norm(p["norm1"], x, cfg.norm, use_kernels),
        (state["tm_x"], state["tm_s"]), cfg, use_kernels)
    x = x + y
    h = apply_norm(p["norm2"], x, cfg.norm, use_kernels)
    y2, cm_x = rwkv_channel_mix(p["channel_mix"], h, state["cm_x"], cfg)
    return x + y2, (tm_x, tm_s, cm_x)


def block_seq(p: dict, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, window: int | None,
              use_kernels: bool = False, layer_kind: str = "dense",
              generator: torch.Generator | None = None):
    """Full-sequence block (prefill and the training loss). Returns (x',
    cache, aux): the cache ``(k, v)``, the hybrid ``{kv, mamba_conv,
    mamba_h}``, or the RWKV state ``{tm_x, tm_s, cm_x}`` after the
    sequence; ``aux`` the MoE layer's load-balancing loss, None for the
    other kinds.  ``generator`` feeds the router noise."""
    if layer_kind == "rwkv":
        state = rwkv_state_init(cfg, x.shape[0], device=x.device)
        x, (tm_x, tm_s, cm_x) = _rwkv_block(p, x, state, cfg, use_kernels)
        return x, {"tm_x": tm_x, "tm_s": tm_s, "cm_x": cm_x}, None
    h = apply_norm(p["norm1"], x, cfg.norm, use_kernels)
    attn_out, kv = attn_prefill(p["attn"], h, cfg, positions, window,
                                use_kernels)
    if layer_kind == "hybrid":
        state = mamba_state_init(cfg, x.shape[0], device=x.device)
        m_out, (conv, m_h) = mamba_seq(p["mamba"], h, state, cfg)
        attn_out = 0.5 * (attn_out + m_out)  # Hymba: mean-fused heads
        kv = {"kv": kv, "mamba_conv": conv, "mamba_h": m_h}
    x = x + attn_out * cfg.residual_scale
    h2 = apply_norm(p["norm2"], x, cfg.norm, use_kernels)
    f_out, aux = _ffn(p["ffn"], h2, cfg, use_kernels, layer_kind, generator)
    return x + f_out * cfg.residual_scale, kv, aux


def block_step(p: dict, x: torch.Tensor, cache, pos: torch.Tensor,
               cfg: ModelConfig, window: int | None,
               use_kernels: bool = False, layer_kind: str = "dense"):
    """Single-token decode. x: [B,1,d]; the cache (``(k, v)``, the hybrid
    dict or the RWKV state) is written in place."""
    if layer_kind == "rwkv":
        x, new = _rwkv_block(p, x, cache, cfg, use_kernels)
        for key, value in zip(("tm_x", "tm_s", "cm_x"), new):
            copy_into(cache[key], value)
        return x, cache
    h = apply_norm(p["norm1"], x, cfg.norm, use_kernels)
    if layer_kind == "hybrid":
        attn_out, _ = attn_decode(p["attn"], h, cache["kv"], pos, cfg,
                                  window, use_kernels)
        m_out, (conv, m_h) = mamba_seq(
            p["mamba"], h, (cache["mamba_conv"], cache["mamba_h"]), cfg)
        copy_into(cache["mamba_conv"], conv)
        copy_into(cache["mamba_h"], m_h)
        attn_out = 0.5 * (attn_out + m_out)
    else:
        attn_out, cache = attn_decode(p["attn"], h, cache, pos, cfg, window,
                                      use_kernels)
    x = x + attn_out * cfg.residual_scale
    h2 = apply_norm(p["norm2"], x, cfg.norm, use_kernels)
    f_out, _ = _ffn(p["ffn"], h2, cfg, use_kernels, layer_kind)
    return x + f_out * cfg.residual_scale, cache


def block_step_paged(p: dict, x: torch.Tensor, pages,
                     block_tables: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig, window: int | None,
                     use_kernels: bool = False, layer_kind: str = "dense"):
    """Single-token decode against paged KV. x: [B,1,d]; pages per layer."""
    h = apply_norm(p["norm1"], x, cfg.norm, use_kernels)
    attn_out, pages = attn_paged_decode(p["attn"], h, pages, block_tables,
                                        pos, cfg, window, use_kernels)
    x = x + attn_out * cfg.residual_scale
    h2 = apply_norm(p["norm2"], x, cfg.norm, use_kernels)
    f_out, _ = _ffn(p["ffn"], h2, cfg, use_kernels, layer_kind)
    return x + f_out * cfg.residual_scale, pages


# ============================ LM facade =====================================

def _head_table(params: dict, cfg: ModelConfig) -> dict:
    return params["embed"] if cfg.tie_embeddings else params["head"]


def _head(params: dict, x: torch.Tensor, cfg: ModelConfig,
          use_kernels: bool) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x, cfg.norm, use_kernels)
    return shard(unembed(_head_table(params, cfg), x), "batch", "seq",
                 "vocab")


def _stack_caches(caches: list):
    """Per-layer caches of one stack → the stacked ``[L, ...]`` cache."""
    if isinstance(caches[0], dict):
        return {k: _stack_caches([c[k] for c in caches]) for k in caches[0]}
    if isinstance(caches[0], tuple):
        return tuple(_stack_caches(list(leaves)) for leaves in zip(*caches))
    return torch.stack(caches)


def _layer_cache(cache, li: int):
    """Layer ``li`` of a stacked cache (views, so writes land in place)."""
    if isinstance(cache, dict):
        return {k: _layer_cache(v, li) for k, v in cache.items()}
    if isinstance(cache, tuple):
        return tuple(_layer_cache(leaf, li) for leaf in cache)
    return cache[li]


def _project_frontend(fe: dict, e: torch.Tensor) -> torch.Tensor:
    """``proj2(gelu(proj1(e)))`` in the promoted dtype of ``e`` and the
    weights (the JAX package's mixed-dtype einsums promote so)."""
    dt = torch.promote_types(e.dtype, fe["proj1"]["w"].dtype)

    def lin(p, h):
        return linear({k: w.to(dt) for k, w in p.items()}, h)
    return lin(fe["proj2"], gelu(lin(fe["proj1"], e.to(dt))))


def _embed_inputs(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                  extra_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """tokens [B,S] → [B,S',d]: the projected modality embeddings
    ``extra_embeds`` [B,N,feat] (if any) prepended, then the meta rows (if
    any) before everything."""
    x = embed(params["embed"], tokens)
    if extra_embeds is not None:
        e = _project_frontend(params["frontend"], extra_embeds)
        x = torch.cat([e.to(x.dtype), x], dim=1)
    if cfg.meta_tokens:
        meta = params["meta"].to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([meta, x], dim=1)
    return shard(x, "batch", "seq", "embed")


def lm_hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
              use_kernels: bool = False, with_cache: bool = True,
              extra_embeds: torch.Tensor | None = None, *,
              remat: bool = False,
              generator: torch.Generator | None = None):
    """The stacks over the embedded inputs → (hidden [B,S',d] before the
    final norm, aux, caches): ``aux`` the sum of the MoE layers'
    load-balancing losses (fp32, 0 without MoE layers), the caches as
    :func:`lm_forward` returns them (None without ``with_cache``).
    ``remat`` recomputes each layer's activations in the backward
    (``torch.utils.checkpoint``, where the reference wraps its scan body in
    ``jax.checkpoint``)."""
    _check_supported(cfg)
    x = _embed_inputs(params, tokens, cfg, extra_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for stack, (kind, n, windows) in zip(params["stacks"], stack_meta(cfg)):
        layer_caches = []
        for li, p_l in enumerate(layer_list(stack, n)):
            def layer(p_l, x, window=_window(windows[li]), kind=kind):
                x, cache, aux = block_seq(p_l, x, cfg, positions, window,
                                          use_kernels, kind, generator)
                return x, (cache if with_cache else None), aux
            if remat:
                x, cache, aux = torch.utils.checkpoint.checkpoint(
                    layer, p_l, x, use_reentrant=False)
            else:
                x, cache, aux = layer(p_l, x)
            if aux is not None:
                aux_total = aux_total + aux
            if with_cache:
                layer_caches.append(cache)
        caches.append(_stack_caches(layer_caches) if with_cache else None)
    return x, aux_total, caches


def lm_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
               use_kernels: bool = False, with_cache: bool = True,
               extra_embeds: torch.Tensor | None = None):
    """Prefill forward → (logits [B,S',V] fp32, caches): per stack ``(k,
    v)`` each ``[L,B,S',KVH,D]``, the hybrid dict of those and the Mamba
    state, or the RWKV state leaves ``[L,B,...]`` (None without
    ``with_cache``).  S' counts the meta tokens and the ``extra_embeds``
    rows."""
    x, _, caches = lm_hidden(params, tokens, cfg, use_kernels, with_cache,
                             extra_embeds)
    return _head(params, x, cfg, use_kernels), caches


def _check_differentiable(x: torch.Tensor, use_kernels: bool) -> None:
    if use_kernels and x.is_cuda:
        raise ValueError("the port's CUDA kernels have no backward: take "
                         "the loss on the plain route (use_kernels=False), "
                         "as the reference's trainer does")


def lm_loss(params: dict, batch: dict, cfg: ModelConfig,
            generator: torch.Generator | None = None,
            use_kernels: bool = False, remat: bool = False):
    """Next-token CE + 0.01·aux (+ 0.3·MTP CE for MTP configs) → (loss,
    metrics ``{ce, aux[, mtp_ce]}``).  batch: ``{tokens, labels[,
    extra_embeds]}``; the logits of the prepended rows (meta tokens, image
    embeddings) are not scored."""
    tokens, labels = batch["tokens"], batch["labels"]
    _check_differentiable(tokens, use_kernels)
    hidden, aux, _ = lm_hidden(params, tokens, cfg, use_kernels,
                               with_cache=False,
                               extra_embeds=batch.get("extra_embeds"),
                               remat=remat, generator=generator)
    # align: logits predict the NEXT token; labels = tokens shifted by 1
    prefix = hidden.shape[1] - labels.shape[1]
    if chunked_ce():
        # the head matmul inside a loop over sequence chunks: the full
        # [B,S,V] fp32 logits never exist
        hidden = apply_norm(params["final_norm"], hidden, cfg.norm,
                            use_kernels)
        ce = chunked_softmax_xent(hidden[:, prefix:],
                                  _head_table(params, cfg)["table"], labels)
    else:
        logits = _head(params, hidden, cfg, use_kernels)
        ce = softmax_xent(logits[:, prefix:], labels)
    loss = ce + 0.01 * aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp_heads:
        mtp_ce = _mtp_loss(params, tokens, labels, cfg)
        loss = loss + MTP_LOSS_WEIGHT * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return loss, metrics


def _mtp_loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction, as the reference's single head:
    one extra block fed ``[embed(t) ‖ embed(t+1)]`` projected back to d,
    predicting t+2."""
    x = embed(params["embed"], tokens)
    x_next = embed(params["embed"], labels)
    h = torch.cat([x[:, :-1], x_next[:, :-1]], dim=-1)
    h = linear(params["mtp"]["proj"], h)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    kind = "dense" if cfg.moe is None else "moe"
    h, _, _ = block_seq(params["mtp"]["block"], h, cfg, positions, None,
                        False, kind)
    h = apply_norm(params["mtp"]["norm"], h, cfg.norm)
    logits = shard(unembed(_head_table(params, cfg), h), "batch", "seq",
                   "vocab")
    return softmax_xent(logits, labels[:, 1:])


def lm_prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
               cache_len: int | None = None, use_kernels: bool = False,
               extra_embeds: torch.Tensor | None = None):
    """Prefill → (last-token logits [B,V], caches): KV caches zero-padded to
    ``cache_len``; recurrent state (no sequence axis) as it is."""
    logits, caches = lm_forward(params, tokens, cfg, use_kernels,
                                extra_embeds=extra_embeds)
    if cache_len is not None:
        caches = [_pad_cache(c, cache_len) for c in caches]
    return logits[:, -1], caches


def _pad_cache(cache, length: int):
    """Zero-pad the sequence axis (2, of ``[L,B,S,...]``) of each KV leaf —
    GQA's ``(k, v)``, MLA's ``(c_kv, k_rope)``, a hybrid stack's ``kv`` —
    to ``length``; recurrent state passes through."""
    if isinstance(cache, dict):
        return ({**cache, "kv": _pad_cache(cache["kv"], length)}
                if "kv" in cache else cache)
    return tuple(torch.nn.functional.pad(
        leaf, [0, 0] * (leaf.dim() - 3) + [0, length - leaf.shape[2]])
        for leaf in cache)


def init_decode_caches(cfg: ModelConfig, batch: int, length: int, *,
                       device: torch.device | str):
    """Empty decode caches per stack: ``(k, v)`` ``[L,B,length,KVH,D]``,
    MLA's ``(c_kv [L,B,length,rank], k_rope [..,rope])`` (under
    ``kv_quant`` the triple of :func:`.attention.init_cache`), the hybrid
    ``{kv, mamba_conv, mamba_h}``, or the RWKV state leaves ``[L,B,...]``."""
    _check_supported(cfg)
    caches = []
    for kind, n, _ in stack_meta(cfg):
        if kind == "rwkv":
            state = rwkv_state_init(cfg, batch, device=device)
            caches.append({k: v.new_zeros((n,) + v.shape)
                           for k, v in state.items()})
            continue
        entry = tuple(leaf.new_zeros((n,) + leaf.shape) for leaf in
                      init_cache(cfg, batch, length, device=device))
        if kind == "hybrid":
            conv, m_h = mamba_state_init(cfg, batch, device=device)
            entry = {"kv": entry,
                     "mamba_conv": conv.new_zeros((n,) + conv.shape),
                     "mamba_h": m_h.new_zeros((n,) + m_h.shape)}
        caches.append(entry)
    return caches


def lm_decode(params: dict, token: torch.Tensor, caches: list,
              pos: torch.Tensor, cfg: ModelConfig,
              use_kernels: bool = False):
    """One decode step. token, pos: [B] int. → (logits [B,V], caches), the
    caches written in place."""
    _check_supported(cfg)
    x = embed(params["embed"], token[:, None])
    if cfg.meta_tokens:
        pos = pos + cfg.meta_tokens
    for stack, cache, (kind, n, windows) in zip(params["stacks"], caches,
                                                stack_meta(cfg)):
        for li in range(n):
            x, _ = block_step(layer_params(stack, li), x,
                              _layer_cache(cache, li), pos, cfg,
                              _window(windows[li]), use_kernels, kind)
    return _head(params, x, cfg, use_kernels)[:, 0], caches


def init_paged_decode_caches(cfg: ModelConfig, num_pages: int,
                             page_size: int, *, device: torch.device | str):
    """Paged KV leaves per stack, zero-filled: ``[L,P,ps,KVH,D]``, or MLA's
    latent ``[L,P,ps,rank]`` and ``[L,P,ps,rope]``."""
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(
            f"family {cfg.family!r} carries recurrent state; paged KV "
            "applies only to pure-attention stacks")
    _check_supported(cfg)
    caches = []
    for _, n, _ in stack_meta(cfg):
        caches.append(tuple(
            leaf.new_zeros((n,) + leaf.shape) for leaf in
            init_paged_cache(cfg, num_pages, page_size, device=device)))
    return caches


def lm_paged_decode(params: dict, token: torch.Tensor, caches: list,
                    block_tables: torch.Tensor, pos: torch.Tensor,
                    cfg: ModelConfig, use_kernels: bool = False):
    """One decode step over paged caches. token, pos: [B]; block_tables:
    [B,MAXP] int32 (shared by every layer). → (logits, caches), the pages
    written in place."""
    _check_supported(cfg)
    x = embed(params["embed"], token[:, None])
    if cfg.meta_tokens:
        pos = pos + cfg.meta_tokens
    for stack, cache, (kind, n, windows) in zip(params["stacks"], caches,
                                                stack_meta(cfg)):
        for li in range(n):
            x, _ = block_step_paged(layer_params(stack, li), x,
                                    _layer_cache(cache, li), block_tables,
                                    pos, cfg, _window(windows[li]),
                                    use_kernels, kind)
    return _head(params, x, cfg, use_kernels)[:, 0], caches
