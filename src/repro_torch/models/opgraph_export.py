"""Export an LM's block structure as an Opara :class:`OpGraph`.

The dense, MoE and RWKV-6 paths of the JAX package's
``models/opgraph_export.py``, node for node: embed → per layer → final norm
→ logits.  A dense layer is norm1 → wq/wk/wv branches → decomposed
attention stages → wo → residual → norm2 → gate∥up → GLU → down → residual.
Attention is decomposed into head-split transpose copies → score GEMM →
scale+mask → softmax → context GEMM → head-merge, and on the cost-only path
(``params=None``) large FF weights become explicit weight-stream DMA ops,
exactly as in the reference, so cost-only graphs of the two packages are
identical and schedule identically.  An MoE layer replaces the FFN with the
expert fan-out: the routed ragged form (router → per-expert gathers with
unequal capacities → gate∥up and down GEMM waves that stack into
``grouped_gemm`` → weighted combine, plus the shared expert) when params are
threaded, else the uniform cost-only form.  An RWKV layer is the five
token-shift mixes, the r/k/v/g and decay projections, the WKV scan (the
``rwkv6`` kernel on the card), group-norm, gate and the channel mix.  A
hybrid (Hymba) layer runs the attention stages (with the layer's window as
a mask) in parallel with the Mamba branch — in_proj, the causal conv, the
B/C/Δ projection, the selective scan — and averages the two heads; like
the reference's, the graph has no node for the meta tokens (ROADMAP C13).

Payload functions close over concrete tensors when ``params`` is given (on
whatever device those tensors live: the CUDA card unless the caller built
them on the CPU); otherwise nodes are cost-only.  Payload-backed exports
keep a SINGLE graph input (weights ride in ``meta["consts"]``).  Payloads
make no host→device copy, since the capturer records them into a CUDA graph.

Reproduced on purpose: like the reference's dense export, this graph applies
NO rotary embedding — raw Q and K feed the scores stage — so its logits are
not the model facade's (ROADMAP queue C).

An MLA layer (DeepSeek-V3) replaces the q/k/v branches with the absorbed
latent form, as the reference's: low-rank query and KV projections, the
query's absorption through ``wk_b`` (with RoPE), the latent KV prep (norm,
RoPE on the shared rope key), the same decomposed attention stages with one
latent KV head (Dk = rank + rope, Dv = rank), then the per-head ``wv_b``
up-projection and ``wo``.

The encoder-decoder export (:func:`build_encdec_opgraph`, Whisper) has two
inputs, the frames and the tokens: the encoder chain (frontend projection,
learned positions, bidirectional attention stages, GELU MLP) and the
decoder chain (embedding, learned positions, causal self-attention, a
cross-attention whose K/V GEMMs read the encoder output, GELU MLP).  Norms
and the MLP activation declare their shapes, so capture never stacks an
encoder stage (1500 rows at full width) with a decoder one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F

from .. import trace as _trace
from ..configs.base import ModelConfig
from ..core.graph import OpGraph, OpKind
from ..kernels.mamba_scan import mamba_scan_stage
from ..core.profiler import (
    elementwise_cost,
    gather_cost,
    gemm_cost,
    norm_cost,
    scan_cost,
)
from .attention import NEG_INF, _mla_scale, causal_window_mask, value_up
from .export_costs import act_gemm_cost, stream_cost
from .ffn import (held_combine, held_counts, held_dispatch, held_experts,
                  held_mlp, held_plan, select_experts)
from .layers import apply_norm, apply_rope, gelu, rmsnorm
from .ssm import RWKV_LORA, _mamba_conv_seq
from .transformer import layer_params, stack_meta


def _w(params, *path):
    if params is None:
        return None
    out = params
    for p in path:
        out = out[p]
    return out


def build_lm_opgraph(cfg: ModelConfig, batch: int, seq: int,
                     params: Any = None, n_layers: int | None = None,
                     moe_branch_cap: int = 16,
                     moe_dispatch: str = "auto",
                     moe_cap_scale: float = 1.0) -> OpGraph:
    """Operator DAG of an LM forward pass (prefill semantics).

    ``n_layers`` trims depth (graph-size control for schedulers/benchmarks);
    MoE fan-out is capped at ``moe_branch_cap`` expert branches per layer.

    ``moe_dispatch`` picks the MoE block structure: ``"uniform"`` emits the
    cost-only fan-out (equal-FLOP expert branches, scatter dispatch/combine
    without payloads); ``"ragged"`` the routed fan-out (real router →
    per-expert token gathers with unequal static capacities → grouped
    ragged-M expert GEMMs → weighted scatter-add combine), executable end
    to end when ``params`` is threaded; ``"auto"`` ragged with params,
    uniform without.  ``moe_cap_scale`` scales the ragged fan-out's
    capacities; below 1 it forces capacity overflow (pairs ranked past
    their expert's capacity contribute zero).
    """
    if moe_dispatch not in ("auto", "ragged", "uniform"):
        raise ValueError(f"unknown moe_dispatch {moe_dispatch!r}")
    if cfg.family == "encdec":
        raise NotImplementedError(f"{cfg.name} is an encoder-decoder model: "
                                  "export it with build_encdec_opgraph")
    with _trace.span("export"):
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
        counts = _held_counter(cfg, params, L, b * s)
        layer_idx = n_moe = 0
        for si, (kind, n, windows) in enumerate(meta):
            for li in range(min(n, max(L - layer_idx, 0))):
                tag = f"L{layer_idx}"
                pl = (layer_params(_w(params, "stacks")[si], li)
                      if params is not None else None)
                if kind == "rwkv":
                    x = _rwkv_layer(g, cfg, x, b, s, tag, pl, root)
                elif kind == "hybrid":
                    x = _hybrid_layer(g, cfg, x, b, s, tag, pl,
                                      windows[li] or None, root)
                elif kind == "moe":
                    x = _dense_layer(g, cfg, x, b, s, tag, pl, root, moe=True,
                                     moe_branch_cap=moe_branch_cap,
                                     moe_dispatch=moe_dispatch,
                                     moe_cap_scale=moe_cap_scale,
                                     held_counts=None if counts is None
                                     else (counts, n_moe))
                    n_moe += 1
                else:
                    x = _dense_layer(g, cfg, x, b, s, tag, pl, root, moe=False)
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
    """Pre/post-norm node.  ``out_shape`` should be declared wherever the
    graph mixes sequence lengths (encoder vs decoder): capture's stacking
    check can only veto a mixed-shape fusion group it can SEE (see
    ``capture._can_stack``)."""
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
# logits/softmax (each product of two operand values exact, sums fp32),
# probabilities cast to V's dtype for the context matmul.  Two bf16 operands
# on the card go straight into a tensor-core batched GEMM with an fp32
# result (no fp32 copy of either); every other pair runs the fp32 einsum.
# Stage payloads are module-level / lru-cached so identical stages across
# layers share one fn object and stack into fused steps at capture.

# attention products recorded on the tensor-core route; capture reads it
# with the kernels' launch counts
attn_tc_products = 0


def tc_route(device_type: str, a_dtype: torch.dtype,
             b_dtype: torch.dtype) -> bool:
    """True iff an attention product takes the tensor-core route: both
    operands bf16 on a CUDA device.  An fp32 or mixed pair keeps the fp32
    einsum, so no operand is ever rounded."""
    return device_type == "cuda" and a_dtype == b_dtype == torch.bfloat16


def _bmm_f32(a, b):
    """``a @ b`` batched, bf16 operands, fp32 accumulation and result."""
    return torch.bmm(a, b, out_dtype=torch.float32)


def _count_tc_product() -> None:
    global attn_tc_products
    attn_tc_products += 1


@functools.lru_cache(maxsize=None)
def _make_split_heads(heads: int):
    def split_heads(x):
        b, s, dd = x.shape
        return x.reshape(b, s, heads, dd // heads).permute(0, 2, 1, 3)
    return split_heads


def _scores_payload(q, k):
    """q: [B,H,S,Dk] head-major; k: [B,KVH,T,Dk] → logits [B,H,S,T] fp32.
    A KV head's query group is one batch entry of ``g·S`` rows."""
    b, nh, s, hd = q.shape
    kvh, t = k.shape[1], k.shape[2]
    if tc_route(q.device.type, q.dtype, k.dtype):
        _count_tc_product()
        qg = q.reshape(b * kvh, nh // kvh * s, hd)
        kg = k.reshape(b * kvh, t, hd)
        return _bmm_f32(qg, kg.transpose(1, 2)).reshape(b, nh, s, t)
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
    """p: [B,H,S,T] fp32 probs; v: [B,KVH,T,Dv] → ctx [B,H,S,Dv].  p is
    rounded to v's dtype once; the product sums in fp32 and rounds once."""
    b, nh, s, t = p.shape
    kvh, dv = v.shape[1], v.shape[-1]
    pg = p.reshape(b, kvh, nh // kvh, s, t).to(v.dtype)
    if tc_route(p.device.type, pg.dtype, v.dtype):
        _count_tc_product()
        out = _bmm_f32(pg.reshape(b * kvh, nh // kvh * s, t),
                       v.reshape(b * kvh, t, dv))
    else:
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


# -- MLA (DeepSeek-style latent attention), decomposed ------------------------

def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


@functools.lru_cache(maxsize=None)
def _make_mla_q_lat(nh: int, nope: int, rope: int, theta: float,
                    scaling=None):
    """Absorbed query: RoPE (YaRN's with ``scaling``) on the rope part,
    ``wk_b`` folded into q_nope (fp32 accumulation, one rounding),
    head-major ``[B,H,S,rank+rope]``."""
    from ..kernels.paged_decode.ref import absorb_query

    def q_lat(qflat, wk_b):
        b, s, _ = qflat.shape
        q = qflat.reshape(b, s, nh, nope + rope)
        q_rope = apply_rope(q[..., nope:], _positions(b, s, qflat.device),
                            theta, scaling)
        lat = absorb_query(q[..., :nope], wk_b.reshape(-1, nh, nope))
        return torch.cat([lat, q_rope], dim=-1).permute(0, 2, 1, 3)
    return q_lat


@functools.lru_cache(maxsize=None)
def _make_mla_kv_prep(rank: int, theta: float, scaling=None):
    """Latent KV: rmsnorm the compressed part, RoPE (YaRN's with
    ``scaling``) on the shared rope key, concatenated — ONE latent head,
    head-major ``[B,1,S,rank+rope]``."""
    def kv_prep(kv, scale):
        b, s, _ = kv.shape
        c_kv = rmsnorm({"scale": scale}, kv[..., :rank])
        k_rope = apply_rope(kv[:, :, None, rank:],
                            _positions(b, s, kv.device), theta,
                            scaling)[:, :, 0]
        return torch.cat([c_kv, k_rope], dim=-1)[:, None]
    return kv_prep


@functools.lru_cache(maxsize=None)
def _make_latent_v(rank: int):
    def latent_v(kcat):
        return kcat[..., :rank]
    return latent_v


@functools.lru_cache(maxsize=None)
def _make_mla_out(nh: int, rank: int, v_head: int):
    """Per-head value up-projection ``[B,S,H·rank] → [B,S,H·v_head]``."""
    def mla_out(lat_flat, wv_b):
        b, s, _ = lat_flat.shape
        return value_up(lat_flat.reshape(b, s, nh, rank), wv_b, v_head)
    return mla_out


def _mla_block(g, cfg, n1, b, s, tag, attn_p):
    """MLA at traced-kernel granularity (absorbed formulation, kvh = 1):
    low-rank Q/KV projections → latent score/context GEMMs with the
    mask+softmax stage explicit → per-head value up-projection → wo.
    Works cost-only and payload-backed alike."""
    m, d, nh = cfg.mla, cfg.d_model, cfg.n_heads
    nope, rope, rank = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    qk_head = nope + rope
    with_fn = attn_p is not None
    cq = _gemm_node(g, f"{tag}.wq_a", n1, attn_p and attn_p["wq_a"],
                    b * s, d, m.q_lora_rank)
    qn = g.add(f"{tag}.q_norm", OpKind.NORM, [cq],
               fn=(lambda h: rmsnorm(attn_p["q_norm"], h)) if with_fn
               else None,
               cost=norm_cost(b * s * m.q_lora_rank))
    qb = _gemm_node(g, f"{tag}.wq_b", qn, attn_p and attn_p["wq_b"],
                    b * s, m.q_lora_rank, nh * qk_head)
    q_lat = g.add(f"{tag}.q_lat", OpKind.GEMM, [qb],
                  fn=_make_mla_q_lat(nh, nope, rope, cfg.rope_theta,
                                     m.rope_scaling)
                  if with_fn else None,
                  cost=gemm_cost(b * s * nh, nope, rank),
                  fuse_sig=("qlat", s, nh, nope, rank),
                  out_shape=(b, nh, s, rank + rope),
                  **({"consts": (attn_p["wk_b"]["w"],)} if with_fn else {}))
    kva = _gemm_node(g, f"{tag}.wkv_a", n1, attn_p and attn_p["wkv_a"],
                     b * s, d, rank + rope)
    kvp = g.add(f"{tag}.kv_prep", OpKind.NORM, [kva],
                fn=_make_mla_kv_prep(rank, cfg.rope_theta, m.rope_scaling)
                if with_fn else None,
                cost=norm_cost(b * s * (rank + rope)),
                fuse_sig=("mlakv", s, rank, rope),
                out_shape=(b, 1, s, rank + rope),
                **({"consts": (attn_p["kv_norm"]["scale"],)}
                   if with_fn else {}))
    vlat = g.add(f"{tag}.v_lat", OpKind.ELEMENTWISE, [kvp],
                 fn=_make_latent_v(rank) if with_fn else None,
                 cost=elementwise_cost(b * s * rank),
                 fuse_sig=("vlat", s, rank), out_shape=(b, 1, s, rank))
    mrg = _attn_core(g, f"{tag}.", q_lat, kvp, vlat, b, s, s, nh, 1,
                     rank + rope, rank, scale=_mla_scale(cfg), causal=True,
                     window=None, with_fn=with_fn)
    aout = g.add(f"{tag}.attn_out", OpKind.GEMM, [mrg],
                 fn=_make_mla_out(nh, rank, m.v_head_dim)
                 if with_fn else None,
                 cost=gemm_cost(b * s * nh, rank, m.v_head_dim),
                 fuse_sig=("mlaout", s, nh, rank, m.v_head_dim),
                 **({"consts": (attn_p["wv_b"]["w"],)} if with_fn else {}))
    return _gemm_node(g, f"{tag}.wo", aout, attn_p and attn_p["wo"],
                      b * s, nh * m.v_head_dim, d)


def _glu(a, c):
    return F.silu(a) * c


def _add(a, c):
    return a + c


def _dense_layer(g, cfg, x, b, s, tag, pl, root, moe: bool,
                 moe_branch_cap: int = 16, moe_dispatch: str = "auto",
                 moe_cap_scale: float = 1.0, held_counts=None):
    d, hd, nh, kvh = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    bias = cfg.qkv_bias
    n1 = _norm_node(g, f"{tag}.norm1", x, pl and pl["norm1"], cfg.norm,
                    b * s * d)
    attn_p = pl["attn"] if pl else None
    if cfg.mla is not None:
        o = _mla_block(g, cfg, n1, b, s, tag, attn_p)
    else:
        # QKV: 3 parallel GEMM branches (the canonical Opara wave) feeding
        # the decomposed attention stages
        q = _gemm_node(g, f"{tag}.wq", n1, attn_p and attn_p["wq"], b * s,
                       d, nh * hd, bias)
        k = _gemm_node(g, f"{tag}.wk", n1, attn_p and attn_p["wk"], b * s,
                       d, kvh * hd, bias)
        v = _gemm_node(g, f"{tag}.wv", n1, attn_p and attn_p["wv"], b * s,
                       d, kvh * hd, bias)
        mrg = _attn_stages(g, f"{tag}.", q, k, v, b, s, s, nh, kvh, hd,
                           causal=True, window=None, with_fn=pl is not None)
        o = _gemm_node(g, f"{tag}.wo", mrg, attn_p and attn_p["wo"], b * s,
                       nh * hd, d, False)
    r1 = g.add(f"{tag}.res1", OpKind.ELEMENTWISE, [x, o],
               fn=_add if pl else None,
               cost=elementwise_cost(b * s * d, n_in=2))
    n2 = _norm_node(g, f"{tag}.norm2", r1, pl and pl["norm2"], cfg.norm,
                    b * s * d)
    if not moe:
        dff = cfg.d_ff
        ffn_p = pl["ffn"] if pl else None
        gate = _ffn_gemm(g, f"{tag}.gate", n2, root, ffn_p and ffn_p["gate"],
                         b * s, d, dff)
        up = _ffn_gemm(g, f"{tag}.up", n2, root, ffn_p and ffn_p["up"],
                       b * s, d, dff)
        prod = g.add(f"{tag}.glu", OpKind.ELEMENTWISE, [gate, up],
                     fn=_glu if pl else None,
                     cost=elementwise_cost(b * s * dff, n_in=2,
                                           flops_per_elem=5))
        down = _ffn_gemm(g, f"{tag}.down", prod, root,
                         ffn_p and ffn_p["down"], b * s, dff, d)
    elif cfg.moe.held_experts:
        down = _moe_held_block(g, cfg, n2, b, s, tag,
                               pl["ffn"] if pl else None, held_counts)
    elif moe_dispatch == "ragged" or (moe_dispatch == "auto"
                                      and pl is not None):
        down = _moe_ragged_block(g, cfg, n2, b, s, tag,
                                 pl["ffn"] if pl else None, moe_branch_cap,
                                 moe_cap_scale)
    else:
        down = _moe_uniform_block(g, cfg, n2, b, s, tag,
                                  pl["ffn"] if pl else None, moe_branch_cap)
    return g.add(f"{tag}.res2", OpKind.ELEMENTWISE, [r1, down],
                 fn=_add if pl else None,
                 cost=elementwise_cost(b * s * d, n_in=2))


def _moe_uniform_block(g, cfg, n2, b, s, tag, moe_p, moe_branch_cap):
    """The cost-only expert fan-out: router → scatter dispatch → equal-FLOP
    expert branches (one ``[d → 3·d_e]`` GEMM each, stacking into one
    ``branch_gemm``) → scatter combine; dispatch and combine carry no
    payload."""
    e = cfg.moe
    d = cfg.d_model
    router = g.add(f"{tag}.router", OpKind.REDUCE, [n2],
                   cost=gemm_cost(b * s, d, e.n_experts))
    disp = g.add(f"{tag}.dispatch", OpKind.SCATTER, [n2, router],
                 cost=gather_cost(b * s * e.top_k, d))
    nb = min(e.n_experts, moe_branch_cap)
    tok_per_branch = b * s * e.top_k / e.n_experts * (e.n_experts / nb)
    outs = []
    for j in range(nb):
        # gate|up|downᵀ of expert j side by side: the x@w payload does the
        # FLOPs the analytic cost models (one [d → 3·d_e] GEMM per branch)
        ew = ({"w": torch.cat([moe_p["experts"]["gate"][j],
                               moe_p["experts"]["up"][j],
                               moe_p["experts"]["down"][j].t()], dim=1)}
              if moe_p is not None else None)
        outs.append(_gemm_node(g, f"{tag}.expert{j}", disp, ew,
                               int(tok_per_branch), d, 3 * e.d_expert,
                               fuse_sig=("egemm", d, e.d_expert)))
    if e.n_shared:
        sp = (moe_p["shared"]
              if moe_p is not None and "shared" in moe_p else None)
        sw = ({"w": torch.cat([sp["gate"]["w"], sp["up"]["w"],
                               sp["down"]["w"].t()], dim=1)}
              if sp is not None else None)
        outs.append(_gemm_node(g, f"{tag}.shared_expert", n2, sw,
                               b * s, d, 3 * e.d_expert * e.n_shared))
    return g.add(f"{tag}.combine", OpKind.SCATTER, outs + [router],
                 cost=gather_cost(b * s * e.top_k, d))


# -- routed (ragged) MoE fan-out ---------------------------------------------
#
# The dispatch and combine payloads both recompute the routing decision from
# the router node's logits (pure, deterministic, cheap next to the expert
# GEMMs), so the graph needs no multi-output node.

def _moe_capacities(n_tokens: int, e, nb: int, top_k: int) -> tuple[int, ...]:
    """Static per-expert capacities, deliberately UNEQUAL (0.5×–1.5× the
    mean routed load) so the exported fan-out is ragged and exercises the
    grouped ragged-M kernel; the total stays near ``capacity_factor`` ×
    routed tokens."""
    base = n_tokens * top_k / nb * e.capacity_factor
    return tuple(max(1, int(round(base * (0.5 + j / max(nb - 1, 1)))))
                 for j in range(nb))


def _topk_routing(logits, bias, e):
    """(combine weights [N, k], expert ids [N, k]) from router logits [...,
    E'] by :func:`repro_torch.models.ffn.select_experts`, the routing rule
    of the layer, with the balancing ``bias`` over the same E' experts and
    the MoE config ``e``."""
    _, top_w, top_idx = select_experts(
        logits.reshape(-1, logits.shape[-1]).float(), bias, e)
    return top_w, top_idx


def _branch_routing(e, nb: int, top_k: int):
    """The MoE config of the ragged fan-out's routing over its first ``nb``
    experts: no group limit (the groups of the whole width do not survive
    the cut)."""
    return dataclasses.replace(e, n_experts=nb, top_k=top_k, n_group=1,
                               topk_group=1)


def _make_router(rw):
    def router(h):
        return torch.matmul(h.float(), rw)
    return router


def _make_dispatch(j: int, cap: int, top_k: int, bias, e):
    """Per-expert token gather: the ``cap`` rows routed to expert ``j``
    (capacity-truncated, zero-padded when fewer arrive).  The cumsum rank
    equals the within-expert rank of a stable sort by expert id, so the
    overflow semantics are the sort dispatch's
    (:func:`repro_torch.models.ffn.moe_ffn_sort`)."""
    def dispatch(h, logits):
        d = h.shape[-1]
        xf = h.reshape(-1, d)
        _, top_idx = _topk_routing(logits, bias, e)
        expert_flat = top_idx.reshape(-1)                       # [N·k]
        tok = torch.arange(expert_flat.shape[0], device=h.device) // top_k
        mine = expert_flat == j
        rank = torch.cumsum(mine.long(), dim=0) - mine.long()   # rank in j
        take = mine & (rank < cap)
        slot = torch.where(take, rank, torch.full_like(rank, cap))
        buf = torch.zeros((cap + 1, d), dtype=xf.dtype, device=h.device)
        buf.index_add_(0, slot, xf[tok] * take[:, None].to(xf.dtype))
        return buf[:cap]
    return dispatch


def _make_glu(dff: int):
    def glu(h):
        return F.silu(h[..., :dff]) * h[..., dff:]
    return glu


def _make_combine(caps: tuple[int, ...], nb: int, top_k: int, bias, e):
    """Weighted scatter-add of the per-expert outputs back to token order:
    each (token, k) pair re-derives its expert and within-expert rank as
    the dispatch nodes did, reads that row of the concatenated expert
    outputs and sums ``router_weight × row`` over k (pairs past capacity
    contribute zero).  The capacity and offset tables are made once per
    device, on the first call (a capture's warm-up), never during graph
    recording."""
    offs = [sum(caps[:j]) for j in range(nb)]
    tables: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def combine(*args):
        *eouts, h, logits = args
        d = h.shape[-1]
        xf = h.reshape(-1, d)
        n = xf.shape[0]
        if h.device not in tables:
            tables[h.device] = (torch.tensor(caps, device=h.device),
                                torch.tensor(offs, device=h.device))
        caps_t, offs_t = tables[h.device]
        top_w, top_idx = _topk_routing(logits, bias, e)
        expert_flat = top_idx.reshape(-1)                       # [N·k]
        w_flat = top_w.reshape(-1)
        onehot = (expert_flat[:, None]
                  == torch.arange(nb, device=h.device)[None, :]).long()
        ranks = torch.cumsum(onehot, dim=0) - onehot
        rank = torch.gather(ranks, 1, expert_flat[:, None])[:, 0]
        cap_e = caps_t[expert_flat]
        take = rank < cap_e
        row = offs_t[expert_flat] + torch.minimum(rank, cap_e - 1)
        allout = torch.cat(eouts, dim=0)                        # [ΣC, d]
        rows = allout[row] * (w_flat * take).to(allout.dtype)[:, None]
        y = rows.reshape(n, top_k, d).sum(dim=1)
        return y.reshape(h.shape).to(h.dtype)
    return combine


def _moe_ragged_block(g, cfg, n2, b, s, tag, moe_p, moe_branch_cap,
                      cap_scale: float = 1.0):
    """Routed expert fan-out with real dispatch/combine payloads.

    router → nb parallel per-expert gathers (unequal static capacities) →
    TWO grouped ragged-M GEMM waves (gate∥up, then down; each stacks into
    ONE ``grouped_gemm`` launch at capture, the branches sharing ``(K, F)``
    but not M) → weighted scatter-add combine (+ the always-on shared
    expert).  Fan-out is capped at ``moe_branch_cap`` branches and routing
    restricted to the first nb experts (their slice of the balancing bias,
    no group limit), so the exported math is self-consistent.
    ``cap_scale`` < 1 shrinks the capacities to force overflow."""
    e = cfg.moe
    d, de = cfg.d_model, e.d_expert
    nb = min(e.n_experts, moe_branch_cap)
    top_k = min(e.top_k, nb)
    caps = tuple(max(1, int(round(c * cap_scale)))
                 for c in _moe_capacities(b * s, e, nb, top_k))
    rw = (moe_p["router"]["w"].float()[:, :nb].contiguous()
          if moe_p is not None else None)
    bias = (moe_p["router"]["bias"].float()[:nb].contiguous()
            if moe_p is not None else None)
    er = _branch_routing(e, nb, top_k)
    router = g.add(
        f"{tag}.router", OpKind.REDUCE, [n2],
        fn=_make_router(rw) if moe_p is not None else None,
        cost=gemm_cost(b * s, d, e.n_experts),
        out_shape=(b, s, nb), out_dtype=torch.float32)
    outs = []
    for j in range(nb):
        disp = g.add(
            f"{tag}.dispatch{j}", OpKind.GATHER, [n2, router],
            fn=(_make_dispatch(j, caps[j], top_k, bias, er)
                if moe_p is not None else None),
            cost=gather_cost(caps[j], d), out_shape=(caps[j], d))
        ew = ({"w": torch.cat([moe_p["experts"]["gate"][j],
                               moe_p["experts"]["up"][j]], dim=1)}
              if moe_p is not None else None)
        h = _gemm_node(g, f"{tag}.expert{j}_in", disp, ew,
                       caps[j], d, 2 * de,
                       fuse_sig=("egemm_in", d, 2 * de),
                       out_shape=(caps[j], 2 * de))
        glu = g.add(f"{tag}.expert{j}_glu", OpKind.ELEMENTWISE, [h],
                    fn=_make_glu(de) if moe_p is not None else None,
                    cost=elementwise_cost(caps[j] * de, n_in=1,
                                          flops_per_elem=5),
                    out_shape=(caps[j], de))
        outs.append(_gemm_node(
            g, f"{tag}.expert{j}_down", glu,
            {"w": moe_p["experts"]["down"][j]} if moe_p is not None else None,
            caps[j], de, d, fuse_sig=("egemm_down", de, d),
            out_shape=(caps[j], d)))
    comb = g.add(
        f"{tag}.combine", OpKind.SCATTER, outs + [n2, router],
        fn=(_make_combine(caps, nb, top_k, bias, er)
            if moe_p is not None else None),
        cost=gather_cost(b * s * e.top_k, d))
    return _with_shared_expert(g, cfg, n2, b, s, tag, moe_p, comb)


def _with_shared_expert(g, cfg, n2, b, s, tag, moe_p, routed):
    """``routed`` plus the always-on shared expert on its own branch
    (gate∥up, GLU, down), which the lanes overlap with the routed part."""
    e = cfg.moe
    d, de = cfg.d_model, e.d_expert
    if not e.n_shared:
        return routed
    dsh = de * e.n_shared
    sp = (moe_p["shared"]
          if moe_p is not None and "shared" in moe_p else None)
    sw = ({"w": torch.cat([sp["gate"]["w"], sp["up"]["w"]], dim=1)}
          if sp is not None else None)
    sh = _gemm_node(g, f"{tag}.shared_in", n2, sw, b * s, d, 2 * dsh,
                    fuse_sig=("sgemm_in", d, 2 * dsh))
    shg = g.add(f"{tag}.shared_glu", OpKind.ELEMENTWISE, [sh],
                fn=_make_glu(dsh) if sp is not None else None,
                cost=elementwise_cost(b * s * dsh, n_in=1, flops_per_elem=5))
    shd = _gemm_node(g, f"{tag}.shared_down", shg,
                     sp["down"] if sp is not None else None,
                     b * s, dsh, d, fuse_sig=("sgemm_down", dsh, d))
    return g.add(f"{tag}.moe_out", OpKind.ELEMENTWISE, [routed, shd],
                 fn=_add if moe_p is not None else None,
                 cost=elementwise_cost(b * s * d, n_in=2))


# -- the expert-parallel MoE layer (a chip's held experts) -----------------------
#
# router (all experts, fp32) → route (the routing rule, once: combine
# weights and expert ids packed as one fp32 [N, k, 2] tensor) → plan (each
# held expert's token rows and routed count, int64 [H, N + 1], all on the
# device) → dispatch (the dropless [H, N, d] buffer) → experts (moe_gemm over
# each held expert's counted rows) → combine (each token's rows gathered,
# weighted and summed); the shared expert beside.
# Nothing waits on the host, so the layer records into the CUDA graph.

def _held_counter(cfg, params, n_layers: int, capacity: int):
    """With tracing on, the counter ``moe.held_counts``: int64 [MoE layers,
    held] on the router's device, each row rewritten by its layer's plan on
    every forward; None otherwise."""
    if not (_trace.on and params is not None and cfg.moe is not None
            and cfg.moe.held_experts):
        return None
    meta = stack_meta(cfg)
    n_moe = 0
    done = 0
    for kind, n, _ in meta:
        take = min(n, max(n_layers - done, 0))
        n_moe += take if kind == "moe" else 0
        done += take
    si = next(i for i, (kind, _, _) in enumerate(meta) if kind == "moe")
    device = params["stacks"][si]["ffn"]["router"]["w"].device
    counts = torch.zeros((n_moe, cfg.moe.held_experts), dtype=torch.int64,
                         device=device)
    first, held = held_experts(cfg.moe)
    _trace.counter("moe.held_counts", counts, capacity=capacity,
                   experts=(first, held), n_experts=cfg.moe.n_experts,
                   top_k=cfg.moe.top_k)
    return counts


@functools.lru_cache(maxsize=None)
def _make_route(e):
    """The routing rule over fp32 router logits [B,S,E] with the balancing
    bias → [N, k, 2]: combine weights, then expert ids (exact in fp32)."""
    def route(logits, bias):
        _, top_w, top_idx = select_experts(
            logits.reshape(-1, logits.shape[-1]), bias, e)
        return torch.stack([top_w, top_idx.float()], dim=-1)
    return route


def _make_plan(first: int, held: int, counter=None):
    def plan(rt):
        out = held_plan(rt[..., 1].long(), first, held)
        if counter is not None:
            counter[0][counter[1]].copy_(out[:, -1])
        return out
    return plan


def _held_dispatch_payload(h, plan):
    return held_dispatch(h.reshape(-1, h.shape[-1]), plan)


def _held_experts_payload(buf, plan, gate, up, down):
    return held_mlp({"gate": gate, "up": up, "down": down}, buf,
                    held_counts(plan), use_kernels=True)


def _make_held_combine(first: int, held: int, shape: tuple[int, ...]):
    def combine(out, rt, plan):
        return held_combine(out, rt[..., 0], rt[..., 1].long(), plan, first,
                            held).reshape(shape)
    return combine


def _moe_held_block(g, cfg, n2, b, s, tag, moe_p, counter=None):
    """The expert-parallel layer of a chip that holds ``held_experts`` of
    the ``n_experts``: routing over all of them, every pair routed to a
    held expert computed (a static buffer of every token an expert, the
    counts on the device, so no pair is dropped and moe_gemm's work follows
    the counts), the held experts' part combined, plus the shared expert.
    ``counter`` (the tracing counter and this layer's row) records the
    counts.  Works cost-only and payload-backed alike."""
    e = cfg.moe
    d, de, n = cfg.d_model, e.d_expert, b * s
    first, held = held_experts(e)
    with_fn = moe_p is not None
    router = g.add(
        f"{tag}.router", OpKind.REDUCE, [n2],
        fn=_make_router(moe_p["router"]["w"].float()) if with_fn else None,
        cost=gemm_cost(n, d, e.n_experts),
        out_shape=(b, s, e.n_experts), out_dtype=torch.float32)
    rt = g.add(f"{tag}.route", OpKind.REDUCE, [router],
               fn=_make_route(e) if with_fn else None,
               cost=elementwise_cost(n * e.n_experts, 4, flops_per_elem=8),
               out_shape=(n, e.top_k, 2), out_dtype=torch.float32,
               **({"consts": (moe_p["router"]["bias"].float(),)}
                  if with_fn else {}))
    plan = g.add(f"{tag}.plan", OpKind.REDUCE, [rt],
                 fn=_make_plan(first, held, counter) if with_fn else None,
                 cost=elementwise_cost(n * held, 8, flops_per_elem=4),
                 out_shape=(held, n + 1), out_dtype=torch.int64)
    disp = g.add(f"{tag}.dispatch", OpKind.GATHER, [n2, plan],
                 fn=_held_dispatch_payload if with_fn else None,
                 cost=gather_cost(held * n, d), out_shape=(held, n, d))
    # the rows the held experts see on average: N·k·held/E
    rows = max(1, round(n * e.top_k * held / e.n_experts))
    ex = moe_p["experts"] if with_fn else None
    experts = g.add(
        f"{tag}.experts", OpKind.GEMM, [disp, plan],
        fn=_held_experts_payload if with_fn else None,
        cost=gemm_cost(rows, d, 3 * de, batch=held),
        out_shape=(held * n + 1, d),
        **({"consts": (ex["gate"], ex["up"], ex["down"])} if with_fn else {}))
    comb = g.add(f"{tag}.combine", OpKind.SCATTER, [experts, rt, plan],
                 fn=_make_held_combine(first, held, (b, s, d))
                 if with_fn else None,
                 cost=gather_cost(n * held, d), out_shape=(b, s, d))
    return _with_shared_expert(g, cfg, n2, b, s, tag, moe_p, comb)


# -- RWKV6 --------------------------------------------------------------------

def _shift_mix(x, mu):
    """Token-shift interpolation from the zero prefill state
    (``ssm._token_shift`` at x_prev = 0)."""
    xs = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    return x + (xs - x) * mu.to(x.dtype)


def _rwkv_decay_payload(a, wb, w_base):
    """w_t = exp(-exp(base + lora_b(tanh(lora_a(x))))) — fp32 decay."""
    w_log = w_base + torch.matmul(torch.tanh(a), wb).float()
    return torch.exp(-torch.exp(w_log))


def _wkv_scan_payload(r, k, v, w, u):
    """The WKV recurrence from the zero state through the ``rwkv6`` wrapper
    (the kernel on the card, its plain version on the CPU)."""
    from ..kernels.rwkv6 import rwkv6_model
    h, hs = u.shape
    b, t, d = r.shape
    rh = r.reshape(b, t, h, hs).float()
    kh = k.reshape(b, t, h, hs).float()
    vh = v.reshape(b, t, h, hs).float()
    wh = w.reshape(b, t, h, hs)
    s0 = torch.zeros((b, h, hs, hs), dtype=torch.float32, device=r.device)
    y, _ = rwkv6_model(rh, kh, vh, wh, u, s0)
    return y.reshape(b, t, d).to(r.dtype)


@functools.lru_cache(maxsize=None)
def _make_rwkv_groupnorm(hs: int):
    """Per-head group-norm (ln_x) in fp32, as ``rwkv_time_mix_seq``."""
    def groupnorm(y, scale, bias):
        b, t, d = y.shape
        yf = y.float().reshape(b, t, d // hs, hs)
        mu = yf.mean(-1, keepdim=True)
        var = yf.var(-1, unbiased=False, keepdim=True)
        yf = (yf - mu) * torch.rsqrt(var + 1e-5)
        return (yf.reshape(b, t, d) * scale.float()
                + bias.float()).to(y.dtype)
    return groupnorm


def _silu_gate(y, go):
    return y * F.silu(go)


def _relu_sq(x):
    return torch.square(torch.relu(x))


def _rwkv_layer(g, cfg, x, b, s, tag, pl, root):
    """RWKV6: five parallel token-shift mixes feeding the r/k/v/g/decay
    projections, the WKV scan, group-norm, silu-gate and the squared-relu
    channel mix."""
    d, dff = cfg.d_model, cfg.d_ff
    hs = cfg.ssm.head_dim if cfg.ssm else 64
    with_fn = pl is not None
    tm = pl["time_mix"] if pl else None
    cm = pl["channel_mix"] if pl else None
    n1 = _norm_node(g, f"{tag}.norm1", x, pl and pl["norm1"], cfg.norm,
                    b * s * d)
    mixes = {}
    for i, nm in enumerate(("r", "k", "v", "g", "w")):
        mixes[nm] = g.add(f"{tag}.mix_{nm}", OpKind.ELEMENTWISE, [n1],
                          fn=_shift_mix if with_fn else None,
                          cost=elementwise_cost(b * s * d, n_in=1,
                                                flops_per_elem=3),
                          fuse_sig=("tshift", s, d),
                          **({"consts": (tm["mu"][i],)} if with_fn else {}))
    pr = {nm: _gemm_node(g, f"{tag}.w{nm}", mixes[nm], tm and tm["w" + nm],
                         b * s, d, d)
          for nm in ("r", "k", "v", "g")}
    la = _gemm_node(g, f"{tag}.w_lora", mixes["w"], tm and tm["w_lora_a"],
                    b * s, d, RWKV_LORA)
    wdec = g.add(f"{tag}.w_decay", OpKind.GEMM, [la],
                 fn=_rwkv_decay_payload if with_fn else None,
                 cost=gemm_cost(b * s, RWKV_LORA, d),
                 fuse_sig=("wdecay", s, d),
                 **({"consts": (tm["w_lora_b"]["w"], tm["w_base"])}
                    if with_fn else {}))
    scan = g.add(f"{tag}.wkv_scan", OpKind.SCAN,
                 [pr["r"], pr["k"], pr["v"], wdec],
                 fn=_wkv_scan_payload if with_fn else None,
                 cost=scan_cost(b, s, d, hs), fuse_sig=("wkv", s, d, hs),
                 **({"consts": (tm["u"],)} if with_fn else {}))
    gn = g.add(f"{tag}.ln_x", OpKind.NORM, [scan],
               fn=_make_rwkv_groupnorm(hs) if with_fn else None,
               cost=norm_cost(b * s * d), fuse_sig=("rwkvgn", s, d, hs),
               **({"consts": (tm["ln_x"]["scale"], tm["ln_x"]["bias"])}
                  if with_fn else {}))
    gated = g.add(f"{tag}.gate_mul", OpKind.ELEMENTWISE, [gn, pr["g"]],
                  fn=_silu_gate if with_fn else None,
                  cost=elementwise_cost(b * s * d, n_in=2, flops_per_elem=5))
    o = _gemm_node(g, f"{tag}.wo", gated, tm and tm["wo"], b * s, d, d)
    r1 = g.add(f"{tag}.res1", OpKind.ELEMENTWISE, [x, o],
               fn=_add if with_fn else None,
               cost=elementwise_cost(b * s * d, n_in=2))
    n2 = _norm_node(g, f"{tag}.norm2", r1, pl and pl["norm2"], cfg.norm,
                    b * s * d)
    cmix = g.add(f"{tag}.cm_mix", OpKind.ELEMENTWISE, [n2],
                 fn=_shift_mix if with_fn else None,
                 cost=elementwise_cost(b * s * d, n_in=1, flops_per_elem=3),
                 fuse_sig=("tshift", s, d),
                 **({"consts": (cm["mu"][0],)} if with_fn else {}))
    ck = _ffn_gemm(g, f"{tag}.cm_k", cmix, root, cm and cm["wk"],
                   b * s, d, dff)
    act = g.add(f"{tag}.cm_act", OpKind.ELEMENTWISE, [ck],
                fn=_relu_sq if with_fn else None,
                cost=elementwise_cost(b * s * dff, n_in=1, flops_per_elem=2))
    cv = _ffn_gemm(g, f"{tag}.cm_v", act, root, cm and cm["wv"],
                   b * s, dff, d)
    return g.add(f"{tag}.res2", OpKind.ELEMENTWISE, [r1, cv],
                 fn=_add if with_fn else None,
                 cost=elementwise_cost(b * s * d, n_in=2))


# -- Hymba (parallel attention ∥ mamba) ---------------------------------------

def _mamba_conv_payload(xz, w):
    """Split in_proj's output, the causal depthwise conv + silu on the x
    half from the zero prefill conv state, z carried along."""
    di = xz.shape[-1] // 2
    xi, z = xz[..., :di], xz[..., di:]
    y, _ = _mamba_conv_seq(w, xi, xi.new_zeros((xi.shape[0],
                                                w.shape[0] - 1, di)))
    return torch.cat([y, z], dim=-1)


def _mamba_xproj_payload(xz, w):
    """B/C/Δ projection of the conved x half; emits [x ‖ z ‖ bcd] so the
    scan stage needs a single input edge."""
    di = xz.shape[-1] // 2
    return torch.cat([xz, xz[..., :di] @ w], dim=-1)


def _head_mix(a, c):
    return 0.5 * (a + c)


def _hybrid_layer(g, cfg, x, b, s, tag, pl, window, root):
    """Hymba: attention and mamba heads in PARALLEL — the paper's Fig. 3
    compute∥memory overlap case (attention compute-bound, the SSM scan
    memory-bound).  The sliding window enters as a mask (costs use the full
    s×t logits the plain payload materialises).  ``mamba_xproj`` is a GEMM
    without the ``matmul`` payload marker: its output width (2·N + 1) is
    the reference's plain matmul inside the payload."""
    d, hd, nh, kvh = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    ssm = cfg.ssm
    di = ssm.expand * d
    with_fn = pl is not None
    attn_p = pl["attn"] if pl else None
    mp = pl["mamba"] if pl else None
    n1 = _norm_node(g, f"{tag}.norm1", x, pl and pl["norm1"], cfg.norm,
                    b * s * d)
    q = _gemm_node(g, f"{tag}.wq", n1, attn_p and attn_p["wq"],
                   b * s, d, nh * hd, cfg.qkv_bias)
    k = _gemm_node(g, f"{tag}.wk", n1, attn_p and attn_p["wk"],
                   b * s, d, kvh * hd, cfg.qkv_bias)
    v = _gemm_node(g, f"{tag}.wv", n1, attn_p and attn_p["wv"],
                   b * s, d, kvh * hd, cfg.qkv_bias)
    mrg = _attn_stages(g, f"{tag}.", q, k, v, b, s, s, nh, kvh, hd,
                       causal=True, window=window, with_fn=with_fn)
    o = _gemm_node(g, f"{tag}.wo", mrg, attn_p and attn_p["wo"],
                   b * s, nh * hd, d)
    # the parallel mamba branch (memory-bound scan against the GEMMs above)
    inp = _gemm_node(g, f"{tag}.mamba_in", n1, mp and mp["in_proj"],
                     b * s, d, 2 * di)
    conv = g.add(f"{tag}.mamba_conv", OpKind.ELEMENTWISE, [inp],
                 fn=_mamba_conv_payload if with_fn else None,
                 cost=elementwise_cost(b * s * di, n_in=1, flops_per_elem=8),
                 fuse_sig=("mconv", s, di),
                 **({"consts": (mp["conv_w"],)} if with_fn else {}))
    xproj = g.add(f"{tag}.mamba_xproj", OpKind.GEMM, [conv],
                  fn=_mamba_xproj_payload if with_fn else None,
                  cost=gemm_cost(b * s, di, 2 * ssm.state_dim + 1),
                  fuse_sig=("mxproj", s, di, ssm.state_dim),
                  **({"consts": (mp["x_proj"]["w"],)} if with_fn else {}))
    # discretise + selective scan + skip + silu(z) gate from the zero state
    # (ssm.mamba_seq's tail): the kernel on the card, its plain version on
    # the CPU
    scan = g.add(f"{tag}.mamba_scan", OpKind.SCAN, [xproj],
                 fn=mamba_scan_stage if with_fn else None,
                 cost=scan_cost(b, s, di, ssm.state_dim),
                 fuse_sig=("mscan", s, di, ssm.state_dim),
                 **({"consts": (mp["a_log"], mp["d_skip"])}
                    if with_fn else {}))
    mo = _gemm_node(g, f"{tag}.mamba_out", scan, mp and mp["out_proj"],
                    b * s, di, d)
    mix = g.add(f"{tag}.head_mix", OpKind.ELEMENTWISE, [o, mo],
                fn=_head_mix if with_fn else None,
                cost=elementwise_cost(b * s * d, n_in=2))
    r1 = g.add(f"{tag}.res1", OpKind.ELEMENTWISE, [x, mix],
               fn=_add if with_fn else None,
               cost=elementwise_cost(b * s * d, n_in=2))
    n2 = _norm_node(g, f"{tag}.norm2", r1, pl and pl["norm2"], cfg.norm,
                    b * s * d)
    ffn_p = pl["ffn"] if pl else None
    gate = _ffn_gemm(g, f"{tag}.gate", n2, root, ffn_p and ffn_p["gate"],
                     b * s, d, cfg.d_ff)
    up = _ffn_gemm(g, f"{tag}.up", n2, root, ffn_p and ffn_p["up"],
                   b * s, d, cfg.d_ff)
    glu = g.add(f"{tag}.glu", OpKind.ELEMENTWISE, [gate, up],
                fn=_glu if with_fn else None,
                cost=elementwise_cost(b * s * cfg.d_ff, n_in=2,
                                      flops_per_elem=5))
    down = _ffn_gemm(g, f"{tag}.down", glu, root, ffn_p and ffn_p["down"],
                     b * s, cfg.d_ff, d)
    return g.add(f"{tag}.res2", OpKind.ELEMENTWISE, [r1, down],
                 fn=_add if with_fn else None,
                 cost=elementwise_cost(b * s * d, n_in=2))


# -- encoder-decoder (Whisper) ------------------------------------------------

def _encdec_attn(g, pre, src_q, src_kv, ap, cfg, b, s, t, causal):
    """Projection GEMMs + decomposed stages for one (self or cross)
    attention; ``src_q``/``src_kv`` may differ (cross-attention reads the
    encoder output for K/V — the parallel branch the paper highlights for
    T5, Fig. 7a)."""
    d, nh, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _gemm_node(g, f"{pre}wq", src_q, ap and ap["wq"],
                   b * s, d, nh * hd, cfg.qkv_bias)
    k = _gemm_node(g, f"{pre}wk", src_kv, ap and ap["wk"],
                   b * t, d, kvh * hd, cfg.qkv_bias)
    v = _gemm_node(g, f"{pre}wv", src_kv, ap and ap["wv"],
                   b * t, d, kvh * hd, cfg.qkv_bias)
    mrg = _attn_stages(g, pre, q, k, v, b, s, t, nh, kvh, hd,
                       causal=causal, with_fn=ap is not None)
    return _gemm_node(g, f"{pre}wo", mrg, ap and ap["wo"],
                      b * s, nh * hd, d)


def _encdec_ffn(g, pre, r_in, n2_src, root, ffn_p, cfg, b, t):
    """norm2 → FF (gelu: up→act→down; swiglu: gate∥up→glu→down) → res.

    Shapes are declared on the activation node: encoder and decoder FF
    stages share fuse signatures but differ in sequence length, and capture
    must SEE that to keep them out of one stacked kernel."""
    d, dff = cfg.d_model, cfg.d_ff
    m = b * t
    with_fn = ffn_p is not None
    if cfg.act == "swiglu":
        gate = _ffn_gemm(g, f"{pre}gate", n2_src, root,
                         ffn_p and ffn_p["gate"], m, d, dff)
        up = _ffn_gemm(g, f"{pre}up", n2_src, root,
                       ffn_p and ffn_p["up"], m, d, dff)
        act = g.add(f"{pre}glu", OpKind.ELEMENTWISE, [gate, up],
                    fn=_glu if with_fn else None,
                    cost=elementwise_cost(m * dff, n_in=2, flops_per_elem=5),
                    out_shape=(b, t, dff))
    else:
        up = _ffn_gemm(g, f"{pre}up", n2_src, root,
                       ffn_p and ffn_p["up"], m, d, dff)
        act = g.add(f"{pre}act", OpKind.ELEMENTWISE, [up],
                    fn=gelu if with_fn else None,
                    cost=elementwise_cost(m * dff, n_in=1, flops_per_elem=8),
                    out_shape=(b, t, dff))
    dn = _ffn_gemm(g, f"{pre}down", act, root, ffn_p and ffn_p["down"],
                   m, dff, d)
    return g.add(f"{pre}res2", OpKind.ELEMENTWISE, [r_in, dn],
                 fn=_add if with_fn else None,
                 cost=elementwise_cost(m * d, n_in=2))


def _enc_layer(g, cfg, enc, b, es, l, pl, root):
    d = cfg.d_model
    n1 = _norm_node(g, f"e{l}.norm1", enc, pl and pl["norm1"], cfg.norm,
                    b * es * d, out_shape=(b, es, d))
    o = _encdec_attn(g, f"e{l}.", n1, n1, pl and pl["attn"], cfg,
                     b, es, es, causal=False)
    r1 = g.add(f"e{l}.res1", OpKind.ELEMENTWISE, [enc, o],
               fn=_add if pl else None,
               cost=elementwise_cost(b * es * d, n_in=2))
    n2 = _norm_node(g, f"e{l}.norm2", r1, pl and pl["norm2"], cfg.norm,
                    b * es * d, out_shape=(b, es, d))
    return _encdec_ffn(g, f"e{l}.", r1, n2, root, pl and pl["ffn"], cfg,
                       b, es)


def _dec_layer(g, cfg, dec, enc_out, b, s, es, l, pl, root):
    """Mirrors encdec.decoder_block_seq: self-attn → cross-attn (K/V from
    the encoder, a branch parallel to the self-attention chain) → FFN."""
    d = cfg.d_model
    n1 = _norm_node(g, f"d{l}.norm1", dec, pl and pl["norm1"], cfg.norm,
                    b * s * d, out_shape=(b, s, d))
    o = _encdec_attn(g, f"d{l}.", n1, n1, pl and pl["self_attn"], cfg,
                     b, s, s, causal=True)
    r1 = g.add(f"d{l}.res1", OpKind.ELEMENTWISE, [dec, o],
               fn=_add if pl else None,
               cost=elementwise_cost(b * s * d, n_in=2))
    nx = _norm_node(g, f"d{l}.norm_x", r1, pl and pl["norm_x"], cfg.norm,
                    b * s * d, out_shape=(b, s, d))
    co = _encdec_attn(g, f"d{l}.cross_", nx, enc_out,
                      pl and pl["cross_attn"], cfg, b, s, es, causal=False)
    rx = g.add(f"d{l}.res_x", OpKind.ELEMENTWISE, [r1, co],
               fn=_add if pl else None,
               cost=elementwise_cost(b * s * d, n_in=2))
    n2 = _norm_node(g, f"d{l}.norm2", rx, pl and pl["norm2"], cfg.norm,
                    b * s * d, out_shape=(b, s, d))
    return _encdec_ffn(g, f"d{l}.", rx, n2, root, pl and pl["ffn"], cfg,
                       b, s)


def build_encdec_opgraph(cfg: ModelConfig, batch: int, dec_seq: int,
                         params: Any = None,
                         n_layers: int | None = None) -> OpGraph:
    """Whisper/T5-style encoder-decoder DAG at traced-kernel granularity:
    the encoder chain and the decoder's cross-attention K/V projections are
    parallel branches until the first cross-attend — the operator-diversity
    case the paper highlights for T5 (Fig. 7a).  Two INPUT nodes, ``frames``
    (float ``[B, T_frames, feat_dim]``) and ``tokens`` (int ``[B,
    dec_seq]``).  ``params`` (an :func:`~.encdec.init_encdec` tree) threads
    real payloads through every node, mirroring ``encdec.encode`` /
    ``decode_seq`` prefill math; ``n_layers`` trims both stacks."""
    g = OpGraph(cfg.name)
    d = cfg.d_model
    b = batch
    fe = cfg.frontend
    L = n_layers if n_layers is not None else cfg.n_layers
    Ld = n_layers if n_layers is not None else (cfg.n_dec_layers
                                                or cfg.n_layers)
    es = fe.n_tokens if fe else 1500
    feat = fe.feat_dim if fe else d
    with_fn = params is not None

    frames = g.add("frames", OpKind.INPUT, out_shape=(b, es, feat))
    # the conv-style audio frontend lowered as one GEMM with bias, through
    # _gemm_node like every projection
    enc = _gemm_node(g, "frontend_proj", frames,
                     params and params["frontend_proj"],
                     b * es, feat, d, bias=True)
    pe = _w(params, "enc_pos")
    enc = g.add("enc_pos", OpKind.ELEMENTWISE, [enc],
                fn=(lambda h: h + pe[None, : h.shape[1]].to(h.dtype))
                if with_fn else None,
                cost=elementwise_cost(b * es * d))
    for l in range(L):
        pl = layer_params(params["enc_blocks"], l) if with_fn else None
        enc = _enc_layer(g, cfg, enc, b, es, l, pl, frames)
    enc = _norm_node(g, "enc_norm", enc, _w(params, "enc_norm"), cfg.norm,
                     b * es * d, out_shape=(b, es, d))

    tokens = g.add("tokens", OpKind.INPUT, out_shape=(b, dec_seq))
    et = _w(params, "embed", "table")
    dec = g.add("dec_embed", OpKind.GATHER, [tokens],
                fn=(lambda t: et[t]) if with_fn else None,
                cost=gather_cost(b * dec_seq, d))
    dp = _w(params, "dec_pos")
    s = dec_seq
    dec = g.add("dec_pos", OpKind.ELEMENTWISE, [dec],
                fn=(lambda h: h + dp[None, : h.shape[1]].to(h.dtype))
                if with_fn else None,
                cost=elementwise_cost(b * s * d))
    for l in range(Ld):
        pl = layer_params(params["dec_blocks"], l) if with_fn else None
        dec = _dec_layer(g, cfg, dec, enc, b, s, es, l, pl, tokens)
    dec = _norm_node(g, "dec_norm", dec, _w(params, "dec_norm"), cfg.norm,
                     b * s * d)
    g.add("logits", OpKind.GEMM, [dec],
          fn=(lambda h: h @ et.t()) if with_fn else None,
          cost=gemm_cost(b * s, d, cfg.vocab_size))
    g.validate()
    return g
