"""Export a dense LM's block structure as an Opara :class:`OpGraph`.

The dense path of the JAX package's ``models/opgraph_export.py``, node for
node: embed → per layer (norm1 → wq/wk/wv branches → decomposed attention
stages → wo → residual → norm2 → gate∥up → GLU → down → residual) → final
norm → logits.  Attention is decomposed into head-split transpose copies →
score GEMM → scale+mask → softmax → context GEMM → head-merge, and on the
cost-only path (``params=None``) large FF weights become explicit
weight-stream DMA ops, exactly as in the reference, so cost-only graphs of
the two packages are identical and schedule identically.

Payload functions close over concrete tensors when ``params`` is given (on
whatever device those tensors live: the CUDA card unless the caller built
them on the CPU); otherwise nodes are cost-only.  Payload-backed exports
keep a SINGLE graph input (weights ride in ``meta["consts"]``).

Reproduced on purpose: like the reference's dense export, this graph applies
NO rotary embedding — raw Q and K feed the scores stage — so its logits are
not the model facade's (ROADMAP queue C).

MoE, MLA, hybrid, RWKV and encoder-decoder exports are not ported yet
(ROADMAP A6) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.graph import OpGraph, OpKind
from ..core.profiler import (
    elementwise_cost,
    gather_cost,
    gemm_cost,
    norm_cost,
)
from .attention import NEG_INF, causal_window_mask
from .export_costs import act_gemm_cost, stream_cost
from .layers import apply_norm
from .transformer import layer_params, stack_meta


def _w(params, *path):
    if params is None:
        return None
    out = params
    for p in path:
        out = out[p]
    return out


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} export is not ported yet (ROADMAP A6)")


def build_lm_opgraph(cfg: ModelConfig, batch: int, seq: int,
                     params: Any = None, n_layers: int | None = None,
                     moe_branch_cap: int = 16,
                     moe_dispatch: str = "auto",
                     moe_cap_scale: float = 1.0) -> OpGraph:
    """Operator DAG of an LM forward pass (prefill semantics).

    ``n_layers`` trims depth (graph-size control for schedulers/benchmarks).
    The MoE arguments keep the reference's signature; MoE configs raise.
    """
    if moe_dispatch not in ("auto", "ragged", "uniform"):
        raise ValueError(f"unknown moe_dispatch {moe_dispatch!r}")
    if cfg.family == "encdec":
        raise _not_ported("encoder-decoder")
    g = OpGraph(cfg.name)
    d = cfg.d_model
    b, s = batch, seq
    L = n_layers if n_layers is not None else cfg.n_layers

    def fn_or_none(f):
        return f if params is not None else None

    root = g.add("tokens", OpKind.INPUT, out_shape=(b, s))
    emb_w = _w(params, "embed", "table")
    x = g.add("embed", OpKind.GATHER, [root],
              fn=fn_or_none(lambda t: emb_w[t]),
              cost=gather_cost(b * s, d), out_shape=(b, s, d))

    meta = stack_meta(cfg)
    layer_idx = 0
    for si, (kind, n, windows) in enumerate(meta):
        for li in range(min(n, max(L - layer_idx, 0))):
            tag = f"L{layer_idx}"
            pl = (layer_params(_w(params, "stacks")[si], li)
                  if params is not None else None)
            if kind != "dense":
                raise _not_ported(f"{kind!r} layer")
            x = _dense_layer(g, cfg, x, b, s, tag, pl, root)
            layer_idx += 1
    x = _norm_node(g, "final_norm", x, _w(params, "final_norm"), cfg.norm,
                   b * s * d)
    head = _w(params, "embed" if cfg.tie_embeddings else "head")
    g.add("logits", OpKind.GEMM, [x],
          fn=fn_or_none(lambda h: h @ head["table"].t()),
          cost=gemm_cost(b * s, d, cfg.vocab_size))
    g.validate()
    return g


def _norm_node(g, name, inp, p, kind, numel, out_shape=None):
    """Pre/post-norm node."""
    return g.add(name, OpKind.NORM, [inp],
                 fn=(lambda h: apply_norm(p, h, kind)) if p is not None else None,
                 cost=norm_cost(numel), out_shape=out_shape)


def _matmul(h, w):
    return h @ w


def _matmul_bias(h, w, bias):
    return h @ w + bias


def _gemm_node(g, name, inp, pl_linear, m, k, n, bias: bool = False,
               cost=None, fuse_sig=None, out_shape=None):
    """GEMM node following the capture contract: weights go in
    meta["consts"] so same-signature branches stack into one fused kernel,
    and a weight-threaded node carries ``payload="matmul"`` — the
    capturer's routing contract for the fused ``branch_gemm`` kernel."""
    cost = cost if cost is not None else gemm_cost(m, k, n)
    fuse_sig = fuse_sig if fuse_sig is not None else ("gemm", k, n, bias)
    if pl_linear is None:
        return g.add(name, OpKind.GEMM, [inp], cost=cost, fuse_sig=fuse_sig,
                     out_shape=out_shape)
    consts = (pl_linear["w"],) + ((pl_linear["b"],) if bias else ())
    return g.add(name, OpKind.GEMM, [inp],
                 fn=_matmul_bias if bias else _matmul,
                 cost=cost, fuse_sig=fuse_sig, consts=consts,
                 out_shape=out_shape, payload="matmul")


def _ffn_gemm(g, name, inp, root, pl_linear, m, k, n, bias: bool = False,
              fuse_sig=None, out_shape=None):
    """Large FF projection.  Cost-only exports split it into a
    weight-stream DMA (GATHER rooted at the graph input, prefetchable
    arbitrarily early) + an activation-roofline GEMM — the paper's
    compute/memory-overlap pair.  Payload-backed exports keep the single
    matmul-marked node (one graph input; the weight rides in ``consts``).
    """
    if pl_linear is not None:
        return _gemm_node(g, name, inp, pl_linear, m, k, n, bias,
                          fuse_sig=fuse_sig, out_shape=out_shape)
    w = g.add(f"{name}_wstream", OpKind.GATHER, [root],
              cost=stream_cost(k * n * 2))
    return g.add(name, OpKind.GEMM, [inp, w], cost=act_gemm_cost(m, k, n),
                 fuse_sig=fuse_sig if fuse_sig is not None
                 else ("gemm", k, n, bias),
                 out_shape=out_shape)


# -- decomposed attention core -----------------------------------------------
#
# Numerics mirror the reference's stages on head-major tensors: fp32
# logits/softmax (operands upcast, so products are exact and sums fp32),
# probabilities cast to V's dtype for the context matmul.  Stage payloads are
# module-level / lru-cached so identical stages across layers share one fn
# object and stack into fused steps at capture.

@functools.lru_cache(maxsize=None)
def _make_split_heads(heads: int):
    def split_heads(x):
        b, s, dd = x.shape
        return x.reshape(b, s, heads, dd // heads).permute(0, 2, 1, 3)
    return split_heads


def _scores_payload(q, k):
    """q: [B,H,S,Dk] head-major; k: [B,KVH,T,Dk] → logits [B,H,S,T] fp32."""
    b, nh, s, hd = q.shape
    kvh, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, nh // kvh, s, hd)
    return torch.einsum("bkgsd,bktd->bkgst", qg.float(),
                        k.float()).reshape(b, nh, s, t)


@functools.lru_cache(maxsize=None)
def _make_scale_mask(scale: float, window: int | None, causal: bool):
    def scale_mask(x):
        s, t = x.shape[-2], x.shape[-1]
        x = x * scale
        if causal:
            m = causal_window_mask(torch.arange(s, device=x.device),
                                   torch.arange(t, device=x.device), window)
            x = torch.where(m, x, NEG_INF)
        return x
    return scale_mask


def _softmax_payload(x):
    return torch.softmax(x, dim=-1)


def _ctx_payload(p, v):
    """p: [B,H,S,T] fp32 probs; v: [B,KVH,T,Dv] → ctx [B,H,S,Dv]."""
    b, nh, s, t = p.shape
    kvh, dv = v.shape[1], v.shape[-1]
    pg = p.reshape(b, kvh, nh // kvh, s, t).to(v.dtype)
    out = torch.einsum("bkgst,bktd->bkgsd", pg.float(), v.float())
    return out.reshape(b, nh, s, dv).to(v.dtype)


def _merge_heads(x):
    b, nh, s, dv = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, nh * dv)


def _attn_core(g, pre, qt, kt, vt, b, s, t, nh, kvh, hd, dv,
               scale, causal, window, with_fn):
    """scores → scale+mask → softmax → ctx → head-merge, from head-major
    Q/K/V nodes.  The scores/ctx pair carries exactly the 4·b·h·s·t·d
    attention FLOPs (2·m·k·n each); mask/softmax are the memory-bound
    stages the scheduler overlaps with neighboring GEMMs."""
    def F_(f):
        return f if with_fn else None
    sc = g.add(f"{pre}scores", OpKind.GEMM, [qt, kt], fn=F_(_scores_payload),
               cost=gemm_cost(b * nh * s, hd, t),
               fuse_sig=("qk", s, t, hd), out_shape=(b, nh, s, t))
    sm = g.add(f"{pre}scale_mask", OpKind.ELEMENTWISE, [sc],
               fn=F_(_make_scale_mask(scale, window, causal)),
               cost=elementwise_cost(b * nh * s * t, 4, flops_per_elem=2),
               fuse_sig=("mask", s, t, scale, window, causal),
               out_shape=(b, nh, s, t))
    sx = g.add(f"{pre}softmax", OpKind.REDUCE, [sm], fn=F_(_softmax_payload),
               cost=elementwise_cost(b * nh * s * t, 4, flops_per_elem=5),
               fuse_sig=("smax", s, t), out_shape=(b, nh, s, t))
    cx = g.add(f"{pre}ctx", OpKind.GEMM, [sx, vt], fn=F_(_ctx_payload),
               cost=gemm_cost(b * nh * s, t, dv),
               fuse_sig=("pv", s, t, dv), out_shape=(b, nh, s, dv))
    return g.add(f"{pre}ctxt", OpKind.ELEMENTWISE, [cx], fn=F_(_merge_heads),
                 cost=elementwise_cost(b * s * nh * dv),
                 fuse_sig=("mrg", s, nh, dv), out_shape=(b, s, nh * dv))


def _attn_stages(g, pre, q, k, v, b, s, t, nh, kvh, hd,
                 scale=None, causal=True, window=None, with_fn=False):
    """Full decomposed attention from flat [B,S,H·D] projection outputs:
    three head-split transpose copies, then :func:`_attn_core`."""
    scale = hd ** -0.5 if scale is None else float(scale)

    def F_(f):
        return f if with_fn else None
    qt = g.add(f"{pre}qt", OpKind.ELEMENTWISE, [q],
               fn=F_(_make_split_heads(nh)),
               cost=elementwise_cost(b * s * nh * hd),
               fuse_sig=("tps", s, nh, hd), out_shape=(b, nh, s, hd))
    kt = g.add(f"{pre}kt", OpKind.ELEMENTWISE, [k],
               fn=F_(_make_split_heads(kvh)),
               cost=elementwise_cost(b * t * kvh * hd),
               fuse_sig=("tps", t, kvh, hd), out_shape=(b, kvh, t, hd))
    vt = g.add(f"{pre}vt", OpKind.ELEMENTWISE, [v],
               fn=F_(_make_split_heads(kvh)),
               cost=elementwise_cost(b * t * kvh * hd),
               fuse_sig=("tps", t, kvh, hd), out_shape=(b, kvh, t, hd))
    return _attn_core(g, pre, qt, kt, vt, b, s, t, nh, kvh, hd, hd,
                      scale, causal, window, with_fn)


def _glu(a, c):
    return F.silu(a) * c


def _add(a, c):
    return a + c


def _dense_layer(g, cfg, x, b, s, tag, pl, root):
    if cfg.mla is not None:
        raise _not_ported("MLA attention")
    if cfg.moe is not None:
        raise _not_ported("MoE FFN")
    d, hd, nh, kvh = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    bias = cfg.qkv_bias
    n1 = _norm_node(g, f"{tag}.norm1", x, pl and pl["norm1"], cfg.norm,
                    b * s * d)
    attn_p = pl["attn"] if pl else None
    # QKV: 3 parallel GEMM branches (the canonical Opara wave) feeding the
    # decomposed attention stages
    q = _gemm_node(g, f"{tag}.wq", n1, attn_p and attn_p["wq"], b * s, d, nh * hd, bias)
    k = _gemm_node(g, f"{tag}.wk", n1, attn_p and attn_p["wk"], b * s, d, kvh * hd, bias)
    v = _gemm_node(g, f"{tag}.wv", n1, attn_p and attn_p["wv"], b * s, d, kvh * hd, bias)
    mrg = _attn_stages(g, f"{tag}.", q, k, v, b, s, s, nh, kvh, hd,
                       causal=True, window=None, with_fn=pl is not None)
    o = _gemm_node(g, f"{tag}.wo", mrg, attn_p and attn_p["wo"], b * s, nh * hd, d, False)
    r1 = g.add(f"{tag}.res1", OpKind.ELEMENTWISE, [x, o],
               fn=_add if pl else None,
               cost=elementwise_cost(b * s * d, n_in=2))
    n2 = _norm_node(g, f"{tag}.norm2", r1, pl and pl["norm2"], cfg.norm,
                    b * s * d)
    dff = cfg.d_ff
    ffn_p = pl["ffn"] if pl else None
    gate = _ffn_gemm(g, f"{tag}.gate", n2, root, ffn_p and ffn_p["gate"],
                     b * s, d, dff)
    up = _ffn_gemm(g, f"{tag}.up", n2, root, ffn_p and ffn_p["up"],
                   b * s, d, dff)
    prod = g.add(f"{tag}.glu", OpKind.ELEMENTWISE, [gate, up],
                 fn=_glu if pl else None,
                 cost=elementwise_cost(b * s * dff, n_in=2, flops_per_elem=5))
    down = _ffn_gemm(g, f"{tag}.down", prod, root, ffn_p and ffn_p["down"],
                     b * s, dff, d)
    return g.add(f"{tag}.res2", OpKind.ELEMENTWISE, [r1, down],
                 fn=_add if pl else None,
                 cost=elementwise_cost(b * s * d, n_in=2))


def build_encdec_opgraph(cfg: ModelConfig, batch: int, dec_seq: int,
                         params: Any = None, **kwargs: Any) -> OpGraph:
    raise _not_ported("encoder-decoder")
