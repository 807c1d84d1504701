"""Encoder-decoder (Whisper-style) assembly: the JAX package's
``models/encdec.py``.

The conv audio frontend is a stub there and here: the model reads
precomputed frame embeddings ``[B, T_frames, feat_dim]`` and a linear
projector (with bias) maps them to ``d_model``.  The encoder is pre-LN
bidirectional self-attention with a GELU MLP; the decoder runs causal
self-attention, cross-attention over the encoder output, then the MLP.
Positions are learned (``enc_pos``, ``dec_pos``); there is no RoPE.

Params are stacked ``[L, ...]`` per stack (``enc_blocks``, ``dec_blocks``)
as the reference's ``jax.vmap`` init stacks them, so a reference tree
converted by :mod:`repro_torch.bridge` and :func:`init_encdec` are
interchangeable; the port loops over the layer index where the reference
scans.  Caches are ``(self_kv, ckv)``, each ``(k, v)`` stacked
``[L, B, T, KVH, D]``: the decoder's self-attention K/V (padded to
``cache_len`` at prefill) and the cross-attention K/V of the encoder output,
computed once at prefill.  Decode writes the self K/V in place and returns
the caches.

Kernel dispatch follows the reference: ``use_kernels`` routes the decoder's
causal self-attention through the flash-attention kernel at prefill and the
decode-attention kernel at decode.  The encoder's self-attention and every
cross-attention are the plain :func:`~.attention._sdpa`, on either route.

Reproduced on purpose (ROADMAP C15): :func:`encdec_decode` adds
``dec_pos[pos[0]]`` to every row, so a batch whose rows sit at different
positions gives them all row 0's learned position.  :func:`encdec_loss`
is the reference's training loss, with ``remat`` recomputing each layer in
the backward.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from ..utils import shard
from .attention import _sdpa, gqa_decode, gqa_prefill, init_gqa
from .ffn import init_mlp, mlp
from .layers import (_normal, apply_norm, check_device, embed, init_embedding,
                     init_linear, init_norm, linear, unembed)
from .losses import softmax_xent
from .transformer import (_layer_cache, _stack_caches, layer_list,
                          layer_params)


def init_encoder_block(generator: torch.Generator, cfg: ModelConfig, *,
                       device: torch.device | str,
                       lead: tuple[int, ...] = ()) -> dict:
    kw = {"device": device, "lead": lead}
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, cfg.dtype, **kw),
        "attn": init_gqa(generator, cfg, **kw),
        "norm2": init_norm(cfg.d_model, cfg.norm, cfg.dtype, **kw),
        "ffn": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, cfg.dtype,
                        **kw),
    }


def encoder_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Bidirectional self-attention block."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    b, s, _ = x.shape
    hd, nh, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = linear(p["attn"]["wq"], h).reshape(b, s, nh, hd)
    k = linear(p["attn"]["wk"], h).reshape(b, s, kvh, hd)
    v = linear(p["attn"]["wv"], h).reshape(b, s, kvh, hd)
    out = _sdpa(q, k, v, None)
    x = x + linear(p["attn"]["wo"], out.reshape(b, s, nh * hd))
    h2 = apply_norm(p["norm2"], x, cfg.norm)
    return x + mlp(p["ffn"], h2, cfg.act)


def init_decoder_block(generator: torch.Generator, cfg: ModelConfig, *,
                       device: torch.device | str,
                       lead: tuple[int, ...] = ()) -> dict:
    kw = {"device": device, "lead": lead}
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, cfg.dtype, **kw),
        "self_attn": init_gqa(generator, cfg, **kw),
        "norm_x": init_norm(cfg.d_model, cfg.norm, cfg.dtype, **kw),
        "cross_attn": init_gqa(generator, cfg, **kw),
        "norm2": init_norm(cfg.d_model, cfg.norm, cfg.dtype, **kw),
        "ffn": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, cfg.dtype,
                        **kw),
    }


def _cross_kv(p_cross: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    b, t, _ = enc_out.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    k = linear(p_cross["wk"], enc_out).reshape(b, t, kvh, hd)
    v = linear(p_cross["wv"], enc_out).reshape(b, t, kvh, hd)
    return k, v


def _cross_attend(p_cross: dict, x: torch.Tensor, ckv,
                  cfg: ModelConfig) -> torch.Tensor:
    b, s, _ = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    q = linear(p_cross["wq"], x).reshape(b, s, nh, hd)
    out = _sdpa(q, ckv[0], ckv[1], None)
    return linear(p_cross["wo"], out.reshape(b, s, nh * hd))


def decoder_block_seq(p: dict, x: torch.Tensor, enc_out: torch.Tensor,
                      cfg: ModelConfig, positions: torch.Tensor,
                      use_kernels: bool = False):
    """Returns (x', (self_kv, cross_kv))."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    attn_out, self_kv = gqa_prefill(p["self_attn"], h, cfg, positions, None,
                                    use_kernels)
    x = x + attn_out
    hx = apply_norm(p["norm_x"], x, cfg.norm)
    ckv = _cross_kv(p["cross_attn"], enc_out, cfg)
    x = x + _cross_attend(p["cross_attn"], hx, ckv, cfg)
    h2 = apply_norm(p["norm2"], x, cfg.norm)
    return x + mlp(p["ffn"], h2, cfg.act), (self_kv, ckv)


def decoder_block_step(p: dict, x: torch.Tensor, cache, pos: torch.Tensor,
                       cfg: ModelConfig, use_kernels: bool = False):
    """One-token decode. x: [B,1,d]; cache: (self_kv, ckv), the self K/V
    written at ``pos`` in place."""
    self_kv, ckv = cache
    h = apply_norm(p["norm1"], x, cfg.norm)
    attn_out, self_kv = gqa_decode(p["self_attn"], h, self_kv, pos, cfg, None,
                                   use_kernels)
    x = x + attn_out
    hx = apply_norm(p["norm_x"], x, cfg.norm)
    x = x + _cross_attend(p["cross_attn"], hx, ckv, cfg)
    h2 = apply_norm(p["norm2"], x, cfg.norm)
    return x + mlp(p["ffn"], h2, cfg.act), (self_kv, ckv)


# ============================ full model ====================================

def init_encdec(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str = "cuda") -> dict:
    """Random encoder-decoder params on ``device`` drawn from ``generator``
    (which must live on that device), the reference's tree and scales:
    linear weights ``d_in**-0.5``, embeddings ``0.02``, learned positions
    ``0.01``, zero biases, unit norms."""
    device = check_device(device)
    fe = cfg.frontend
    n_dec = cfg.n_dec_layers or cfg.n_layers
    d, dt = cfg.d_model, cfg.dtype
    return {
        "frontend_proj": init_linear(generator, fe.feat_dim, d, True, dt,
                                     device=device),
        "enc_pos": _normal(generator, (fe.n_tokens, d), 0.01, dt, device),
        "enc_blocks": init_encoder_block(generator, cfg, device=device,
                                         lead=(cfg.n_layers,)),
        "enc_norm": init_norm(d, cfg.norm, dt, device=device),
        "embed": init_embedding(generator, cfg.vocab_size, d, dt,
                                device=device),
        "dec_pos": _normal(generator, (cfg.max_seq_len, d), 0.01, dt, device),
        "dec_blocks": init_decoder_block(generator, cfg, device=device,
                                         lead=(n_dec,)),
        "dec_norm": init_norm(d, cfg.norm, dt, device=device),
    }


def _n_layers(stack: dict) -> int:
    return stack["norm1"]["scale"].shape[0]


def _run_layer(fn, remat: bool, *args):
    """``fn(*args)``, its activations recomputed in the backward when
    ``remat`` (the reference's ``jax.checkpoint`` around its scan body)."""
    if remat:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, *,
           remat: bool = False) -> torch.Tensor:
    """frames: [B, T_frames, feat_dim] (precomputed stub embeddings) →
    the normed encoder output [B, T_frames, d]."""
    x = linear(params["frontend_proj"], frames)
    x = shard(x + params["enc_pos"][None, : x.shape[1]], "batch", "seq",
              "embed")
    stack = params["enc_blocks"]
    for p_l in layer_list(stack, _n_layers(stack)):
        x = _run_layer(lambda p_l, x: encoder_block(p_l, x, cfg), remat,
                       p_l, x)
    return apply_norm(params["enc_norm"], x, cfg.norm)


def decode_seq(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig, use_kernels: bool = False, *,
               remat: bool = False):
    """Teacher-forced decoder pass → (logits [B,S,V] fp32, caches)."""
    b, s = tokens.shape
    x = embed(params["embed"], tokens) + params["dec_pos"][None, :s]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    stack = params["dec_blocks"]
    caches = []
    for p_l in layer_list(stack, _n_layers(stack)):
        x, cache = _run_layer(
            lambda p_l, x: decoder_block_seq(p_l, x, enc_out, cfg, positions,
                                             use_kernels),
            remat, p_l, x)
        caches.append(cache)
    x = apply_norm(params["dec_norm"], x, cfg.norm)
    return unembed(params["embed"], x), _stack_caches(caches)


def encdec_loss(params: dict, batch: dict, cfg: ModelConfig,
                generator: torch.Generator | None = None,
                use_kernels: bool = False, remat: bool = False):
    """Teacher-forced decoder CE over ``batch = {frames, tokens, labels}``
    → (loss, ``{ce}``), the reference's ``encdec_loss``."""
    from .transformer import _check_differentiable
    _check_differentiable(batch["tokens"], use_kernels)
    enc_out = encode(params, batch["frames"], cfg, remat=remat)
    logits, _ = decode_seq(params, batch["tokens"], enc_out, cfg, use_kernels,
                           remat=remat)
    ce = softmax_xent(shard(logits, "batch", "seq", "vocab"), batch["labels"])
    return ce, {"ce": ce}


def encdec_prefill(params: dict, frames: torch.Tensor, tokens: torch.Tensor,
                   cfg: ModelConfig, cache_len: int,
                   use_kernels: bool = False):
    """Encode, then the decoder over the prompt → (last-token logits [B,V],
    (self_kv zero-padded to ``cache_len``, ckv))."""
    enc_out = encode(params, frames, cfg)
    logits, (self_kv, ckv) = decode_seq(params, tokens, enc_out, cfg,
                                        use_kernels)
    self_kv = tuple(torch.nn.functional.pad(
        leaf, (0, 0, 0, 0, 0, cache_len - leaf.shape[2])) for leaf in self_kv)
    return logits[:, -1], (self_kv, ckv)


def encdec_decode(params: dict, token: torch.Tensor, caches,
                  pos: torch.Tensor, cfg: ModelConfig,
                  use_kernels: bool = False):
    """One decode step. token, pos: [B] int → (logits [B,V], caches), the
    self K/V written in place.  Every row takes ``dec_pos[pos[0]]`` (C15);
    the row is gathered on the device, so the step records into a CUDA
    graph."""
    x = embed(params["embed"], token[:, None])
    x = x + params["dec_pos"][pos[:1].long()][None]
    stack = params["dec_blocks"]
    for li in range(_n_layers(stack)):
        x, _ = decoder_block_step(layer_params(stack, li), x,
                                  _layer_cache(caches, li), pos, cfg,
                                  use_kernels)
    x = apply_norm(params["dec_norm"], x, cfg.norm)
    return unembed(params["embed"], x)[:, 0], caches
