"""Analytic per-step FLOP / HBM-byte model for every (arch × shape) cell.

Why analytic: XLA's ``cost_analysis()`` counts every while-loop body ONCE —
the layer scan, the flash-attention chunk scans, and GSPMD's windowed-einsum
loops all divide the reported FLOPs by their (nested) trip counts, and the
factors differ per cell.  Rather than reverse-engineering loop trip counts
out of optimized HLO, the roofline's compute/memory terms come from the
explicit formulas below (the same quantities MaxText-style frameworks
napkin-math), while the compiled artifact contributes what it measures
reliably: per-device memory_analysis (capacity proof) and the collective
schedule.  HLO FLOPs are still recorded as a cross-check lower bound.

All numbers are GLOBAL per step; the roofline divides by chip count.
Conventions: matmul fwd = 2·m·k·n; bwd = 2× fwd; remat="block" recomputes
the fwd once during bwd (matmul train factor 8 instead of 6); causal
attention scores count the full rectangle /2.

A copy of the JAX package's ``launch/analytic_cost.py``, formulas and
flag reads unchanged, so both packages give the same numbers for every
cell.  The where-mode cache-update term (decode, 2× the cache) describes
XLA's where-select rewrite of the whole cache, which the port never does
(it writes one slot in place under either ``REPRO_CACHE_UPDATE``): a
bound for a port decode is taken with ``REPRO_CACHE_UPDATE=scatter``.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig, ShapeCell
from ..flags import (cache_update_mode, causal_skip, chunked_ce, kv_quant,
                     window_slice_decode)
from ..models.transformer import cfg_dense_prefix, stack_meta


@dataclasses.dataclass
class CellCost:
    flops: float
    bytes: float
    detail: dict


def _attn_ctx(cfg: ModelConfig, s: int) -> float:
    """Mean COMPUTED context per query across layers.

    The baseline flash implementation computes every KV chunk and masks
    (full rectangle, eff = s); with §Perf O5 (REPRO_CAUSAL_SKIP) fully
    masked chunks are skipped at runtime, so causal layers compute s/2 and
    windowed layers ≈ their window."""
    skip = causal_skip()
    total = 0.0
    n = 0
    for _, cnt, windows in stack_meta(cfg):
        for w in windows:
            if skip:
                eff = s / 2 if (w == 0 or w >= s) else min(w, s)
            else:
                eff = s
            total += eff
            n += 1
    return total / max(n, 1)


def _layer_matmul_params(cfg: ModelConfig) -> tuple[float, float]:
    """(active matmul params per MoE/attn layer, dense-prefix layer params)."""
    d = cfg.d_model
    hd = cfg.head_dim
    if cfg.family == "ssm":
        hs = cfg.ssm.head_dim if cfg.ssm else 64
        p = 4 * d * d + d * d  # r,k,v,g,o  (w-lora ~ small)
        p += 2 * d * cfg.d_ff  # channel mix
        return float(p), 0.0
    if cfg.mla is not None:
        m = cfg.mla
        attn = (d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads *
                (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + cfg.n_heads * m.v_head_dim * d)
    else:
        attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
            + cfg.n_heads * hd * d
    if cfg.moe is not None:
        e = cfg.moe
        ffn_active = (e.top_k + e.n_shared) * 3 * d * e.d_expert + d * e.n_experts
    else:
        mult = 3 if cfg.act == "swiglu" else 2
        ffn_active = mult * d * cfg.d_ff
    layer = attn + ffn_active
    if cfg.family == "hybrid" and cfg.ssm is not None:
        di = cfg.ssm.expand * d
        layer += 2 * d * di + di * (2 * cfg.ssm.state_dim + 1) + di * d
    dense_layer = attn + (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
    return float(layer), float(dense_layer)


def cell_cost(cfg: ModelConfig, cell: ShapeCell, remat: bool = True) -> CellCost:
    b = cell.global_batch
    s = cell.seq_len + cfg.meta_tokens if cell.step != "decode" else 1
    ctx = cell.seq_len + cfg.meta_tokens
    d = cfg.d_model
    v = cfg.vocab_size
    tokens = b * s
    if cfg.family == "vlm" and cfg.frontend and cell.step != "decode":
        tokens = b * cell.seq_len  # text + image tokens add to the budget
    if cfg.family == "encdec" and cell.step != "decode":
        tokens = b * cell.seq_len

    layer_p, dense_p = _layer_matmul_params(cfg)
    prefix = cfg_dense_prefix(cfg)
    n_moe = cfg.n_layers - prefix
    matmul_params = n_moe * layer_p + prefix * dense_p
    if cfg.family == "encdec":
        n_dec = cfg.n_dec_layers or cfg.n_layers
        matmul_params = (cfg.n_layers + n_dec) * layer_p \
            + n_dec * 2 * d * cfg.n_kv_heads * cfg.head_dim  # cross-attn KV

    # -- matmul flops ---------------------------------------------------------
    fwd_factor = {"train": 2.0, "prefill": 2.0, "decode": 2.0}[cell.step]
    train_factor = 8.0 if remat else 6.0   # fwd + (recompute) + bwd
    factor = train_factor if cell.step == "train" else fwd_factor
    mm_flops = factor * tokens * matmul_params

    # head + embedding matmul
    head_flops = factor * tokens * d * v
    if cell.step == "decode":
        head_flops = 2.0 * b * d * v

    # -- attention flops ------------------------------------------------------
    attn_flops = 0.0
    if cfg.family != "ssm":
        nh, hd = cfg.n_heads, cfg.head_dim
        if cfg.mla is not None:
            hd_k = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
            hd_v = cfg.mla.kv_lora_rank
        else:
            hd_k = hd_v = hd
        n_attn = cfg.n_layers + (cfg.n_dec_layers or 0)
        if cell.step == "decode":
            attn_flops = 2.0 * b * nh * ctx * (hd_k + hd_v) * n_attn
        else:
            mean_ctx = _attn_ctx(cfg, s)
            per_layer = 2.0 * b * s * mean_ctx * nh * (hd_k + hd_v)
            mult = (2.5 if remat else 2.0) if cell.step == "train" else 1.0
            # bwd of flash ≈ 2.5× fwd matmul work (dq, dk, dv + recompute p)
            attn_flops = per_layer * n_attn * (1.0 + mult
                                               if cell.step == "train" else 1.0)
        if cfg.family == "encdec" and cell.step != "decode":
            fe = cfg.frontend
            n_dec = cfg.n_dec_layers or cfg.n_layers
            attn_flops += 2.0 * b * (fe.n_tokens ** 2) * nh * 2 * hd * cfg.n_layers
            attn_flops += 2.0 * b * s * fe.n_tokens * nh * 2 * hd * n_dec

    # -- recurrence flops (ssm / hybrid) ---------------------------------------
    scan_flops = 0.0
    if cfg.family == "ssm":
        hs = cfg.ssm.head_dim if cfg.ssm else 64
        scan_flops = 10.0 * tokens * d * hs * cfg.n_layers
    elif cfg.family == "hybrid":
        di = cfg.ssm.expand * d
        scan_flops = 8.0 * tokens * di * cfg.ssm.state_dim * cfg.n_layers
    if cell.step == "train":
        scan_flops *= 3.0

    flops = mm_flops + head_flops + attn_flops + scan_flops

    # -- bytes ------------------------------------------------------------------
    p_total = cfg.n_params()
    p_active = cfg.n_active_params()
    dt = 2.0  # bf16
    if cell.step == "train":
        # params r (fwd) + r (bwd) + grads w+r + adam m,v fp32 r+w + master w
        param_traffic = p_total * (dt * 3 + 4 * 2 + 8 * 2 + 4)
        act_traffic = tokens * d * dt * 14 * (cfg.n_layers + (cfg.n_dec_layers or 0))
        if chunked_ce():
            # §Perf O3: logits live chunk-at-a-time and mostly fuse; residual
            # spill ≈ half of one pass over the logits volume.
            ce_traffic = 0.5 * tokens * v * 4.0
        else:
            ce_traffic = 3.0 * tokens * v * 4.0   # fp32 logits w + r + dlogits
        bytes_ = param_traffic + act_traffic + ce_traffic
    elif cell.step == "prefill":
        param_traffic = p_active * dt + (p_total - p_active) * dt * min(
            1.0, tokens / max(cfg.moe.n_experts if cfg.moe else 1, 1))
        act_traffic = tokens * d * dt * 10 * (cfg.n_layers + (cfg.n_dec_layers or 0))
        kv_write = _cache_bytes(cfg, b, ctx)
        bytes_ = param_traffic + act_traffic + kv_write + tokens * v * 4.0
    else:  # decode
        cache = _cache_bytes(cfg, b, ctx)
        # baseline where-select cache update rewrites the buffer (read +
        # write on top of the attention read); §Perf O1 scatter touches one
        # slot per sequence.
        update = 2.0 if cache_update_mode() != "scatter" else 0.01
        read = 1.0
        if window_slice_decode() and cfg.window:
            # §Perf O6: windowed layers read window+1 slots, global layers
            # read the full cache.
            n_l = cfg.n_layers
            n_glob = len(cfg.global_layers)
            read = (n_glob + (n_l - n_glob) * min(1.0, (cfg.window + 1) / ctx)) / n_l
        param_traffic = p_active * dt if cfg.moe is None else \
            min(p_total, p_active * b) * dt
        bytes_ = param_traffic + cache * (read + update) + b * v * 4.0
    return CellCost(flops=float(flops), bytes=float(bytes_), detail={
        "matmul_flops": mm_flops, "head_flops": head_flops,
        "attn_flops": attn_flops, "scan_flops": scan_flops,
        "param_bytes": p_total * dt,
        "cache_bytes": _cache_bytes(cfg, b, ctx) if cell.step != "train" else 0.0,
    })


def _cache_bytes(cfg: ModelConfig, b: int, ctx: int) -> float:
    dt = 2.0
    if cfg.family == "ssm":
        hs = cfg.ssm.head_dim if cfg.ssm else 64
        h = cfg.d_model // hs
        return float(cfg.n_layers * b * (h * hs * hs * 4 + 2 * cfg.d_model * dt))
    if cfg.mla is not None:
        if kv_quant():   # §Perf O8: int8 latent + f16 scale + bf16 rope keys
            per_tok_bytes = cfg.mla.kv_lora_rank + 2 + cfg.mla.qk_rope_head_dim * dt
            return float(cfg.n_layers * b * ctx * per_tok_bytes)
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return float(cfg.n_layers * b * ctx * per_tok * dt)
    kv = 2 * cfg.n_kv_heads * cfg.head_dim
    n_layers = cfg.n_layers + (cfg.n_dec_layers or 0)
    total = float(n_layers * b * ctx * kv * dt)
    if cfg.family == "hybrid":
        di = cfg.ssm.expand * cfg.d_model
        total += cfg.n_layers * b * di * (cfg.ssm.state_dim * 4 + 3 * dt)
    return total
