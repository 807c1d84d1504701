"""An MLA + MoE decoder (DeepSeek-V3) as one chip of an expert-parallel
deployment: the port's parameter layout and the benchmark's own counts of
a forward's work at the chip's share.

The chip holds ``moe.held_experts`` of the ``moe.n_experts`` routed
experts; the router keeps every output.  A forward's routed pairs that
land on the held experts are counted at their expected number, N · top_k ·
held / n_experts (uniform routing), split evenly over the held experts.
"""
from __future__ import annotations

from portbench.families.common import (DTYPE_BYTES, causal_pairs,
                                       head_product, product_flops)


def dense_prefix(cfg: dict) -> int:
    """The leading dense layers (at least one layer stays MoE)."""
    return min(cfg["moe"]["dense_prefix"], max(cfg["n_layers"] - 1, 0))


def _block(cfg: dict, lead: tuple, moe: bool) -> list:
    d, nh, m = cfg["d_model"], cfg["n_heads"], cfg["mla"]
    nope, rope = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    q_rank, kv_rank, v = m["q_lora_rank"], m["kv_lora_rank"], m["v_head_dim"]
    out = [(("norm1", "scale"), lead + (d,), "norm"),
           (("attn", "wq_a", "w"), lead + (d, q_rank), "linear"),
           (("attn", "q_norm", "scale"), lead + (q_rank,), "norm"),
           (("attn", "wq_b", "w"), lead + (q_rank, nh * (nope + rope)),
            "linear"),
           (("attn", "wkv_a", "w"), lead + (d, kv_rank + rope), "linear"),
           (("attn", "kv_norm", "scale"), lead + (kv_rank,), "norm"),
           (("attn", "wk_b", "w"), lead + (kv_rank, nh * nope), "linear"),
           (("attn", "wv_b", "w"), lead + (kv_rank, nh * v), "linear"),
           (("attn", "wo", "w"), lead + (nh * v, d), "linear"),
           (("norm2", "scale"), lead + (d,), "norm")]
    if not moe:
        f = cfg["d_ff"]
        return out + [(("ffn", "gate", "w"), lead + (d, f), "linear"),
                      (("ffn", "up", "w"), lead + (d, f), "linear"),
                      (("ffn", "down", "w"), lead + (f, d), "linear")]
    e = cfg["moe"]
    n, held, f = e["n_experts"], e["held_experts"], e["d_expert"]
    # the router's weight and balancing bias in float32, as the port keeps
    # them; the experts are the held ones
    out += [(("ffn", "router", "w"), lead + (d, n), "linear", "float32"),
            (("ffn", "router", "bias"), lead + (n,), "bias", "float32"),
            (("ffn", "experts", "gate"), lead + (held, d, f), "linear"),
            (("ffn", "experts", "up"), lead + (held, d, f), "linear"),
            (("ffn", "experts", "down"), lead + (held, f, d), "linear")]
    if e["n_shared"]:
        fs = f * e["n_shared"]
        out += [(("ffn", "shared", "gate", "w"), lead + (d, fs), "linear"),
                (("ffn", "shared", "up", "w"), lead + (d, fs), "linear"),
                (("ffn", "shared", "down", "w"), lead + (fs, d), "linear")]
    return out


def leaves(cfg: dict) -> list[tuple]:
    """Every parameter of the port's ``init_lm`` tree: (path, shape, init)
    or (path, shape, init, dtype), the layers of each stack stacked along
    a leading dim (the dense prefix, then the MoE layers)."""
    L, d, V = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
    dense = dense_prefix(cfg)
    stacks = ([(dense, False)] if dense else []) + [(L - dense, True)]
    out = [(("embed", "table"), (V, d), "embed")]
    for i, (n, moe) in enumerate(stacks):
        out += [(("stacks", i) + p, shape, *rest)
                for p, shape, *rest in _block(cfg, (n,), moe)]
    out.append((("final_norm", "scale"), (d,), "norm"))
    if not cfg["tie_embeddings"]:
        out.append((("head", "table"), (V, d), "embed"))
    return out


def routed_rows(cfg: dict, rows: int) -> float:
    """The routed pairs a forward's ``rows`` tokens send to the held
    experts, at their expected number."""
    e = cfg["moe"]
    return rows * e["top_k"] * e["held_experts"] / e["n_experts"]


def attention_products(cfg: dict, rows: int) -> list:
    """MLA's weight products at this chip's heads: the low-rank query and
    KV projections, the per-head key (``wk_b``) and value (``wv_b``)
    up-projections, and ``wo``."""
    d, nh, m = cfg["d_model"], cfg["n_heads"], cfg["mla"]
    nope, rope = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    rank, v = m["kv_lora_rank"], m["v_head_dim"]
    return ([("wq_a", rows, d, m["q_lora_rank"]),
             ("wq_b", rows, m["q_lora_rank"], nh * (nope + rope)),
             ("wkv_a", rows, d, rank + rope)]
            + [("wk_b", rows, nope, rank)] * nh
            + [("wv_b", rows, rank, v)] * nh
            + [("wo", rows, nh * v, d)])


def expert_products(cfg: dict, rows: int) -> list:
    """The held experts' products of one MoE layer: gate, up and down of
    each, at its share of the routed rows."""
    e = cfg["moe"]
    d, f, held = cfg["d_model"], e["d_expert"], e["held_experts"]
    m = routed_rows(cfg, rows) / held
    return [("expert_gate", m, d, f), ("expert_up", m, d, f),
            ("expert_down", m, f, d)] * held


def moe_layers(cfg: dict) -> int:
    return cfg["n_layers"] - dense_prefix(cfg)


def products(cfg: dict, batch: int, seq: int):
    """Every weight product of one forward at the chip's share."""
    rows = batch * seq
    d, e = cfg["d_model"], cfg["moe"]
    fs = e["d_expert"] * e["n_shared"]
    attn = attention_products(cfg, rows)
    dense = attn + [("gate", rows, d, cfg["d_ff"]),
                    ("up", rows, d, cfg["d_ff"]),
                    ("down", rows, cfg["d_ff"], d)]
    moe = (attn + [("router", rows, d, e["n_experts"])]
           + expert_products(cfg, rows)
           + [("shared_gate", rows, d, fs), ("shared_up", rows, d, fs),
              ("shared_down", rows, fs, d)])
    return (dense * dense_prefix(cfg) + moe * moe_layers(cfg)
            + [head_product(cfg, rows)])


def model_flops(cfg: dict, batch: int, seq: int) -> int:
    """Weight products and MLA's attention over the causal pairs, in its
    published form: scores over the 192 query / key dims and the context
    over the 128 value dims of each of this chip's heads."""
    m = cfg["mla"]
    qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    attn = (2 * batch * cfg["n_heads"] * causal_pairs(seq, None)
            * (qk + m["v_head_dim"]))
    return (sum(product_flops(mm, k, n) for _, mm, k, n in
                products(cfg, batch, seq)) + cfg["n_layers"] * attn)


def expected_counts(cfg: dict, batch: int, seq: int) -> list[list[float]]:
    """Each MoE layer's routed rows per held expert under uniform routing:
    N · top_k / n_experts each."""
    e = cfg["moe"]
    each = routed_rows(cfg, batch * seq) / e["held_experts"]
    return [[each] * e["held_experts"] for _ in range(moe_layers(cfg))]


def expert_mlp_work(cfg: dict, counts) -> list[tuple[float, float]]:
    """(operations, bytes) of the held experts' MLP in each MoE layer of a
    forward whose routed rows per held expert are ``counts`` ([layer]
    [expert]): the rows' three products, and the weights of each held
    expert with a row read once plus the rows in and out, in the served
    dtype."""
    d, f = cfg["d_model"], cfg["moe"]["d_expert"]
    size = DTYPE_BYTES[cfg["dtype"]]
    out = []
    for layer in counts:
        rows = sum(layer)
        active = sum(c > 0 for c in layer)
        out.append((2.0 * rows * d * f * 3,
                    size * (active * 3 * d * f + 2 * rows * d)))
    return out


def expert_mlp_least_seconds(cfg: dict, counts, peaks: dict) -> float:
    """The least time of the held experts' MLP in a forward with these
    ``counts``: per MoE layer the larger of its operations over the bf16
    peak and its bytes over the bandwidth."""
    return sum(max(flops / peaks["bf16_flops"],
                   nbytes / peaks["hbm_bytes_per_s"])
               for flops, nbytes in expert_mlp_work(cfg, counts))
