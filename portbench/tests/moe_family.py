"""A test-only family: the port's parameter layout of an MLA + MoE
decoder (DeepSeek-V3's form), dropped into a copy of the benchmark as
``families/moe.py`` by ``test_portbench_config.py`` to show that such a
configuration needs no edit of the harness.  The router's weight and
balancing bias are float32 leaves, as the port keeps them.  It lists no
counts: a cell of this family brings its own ``families/moe.py``."""
from __future__ import annotations

# the MoE family's dense first layers, by configuration (the port picks
# them by name, models/transformer.py:cfg_dense_prefix)
DENSE_PREFIX = {"deepseek-v3-671b": 3, "kimi-k2-1t-a32b": 1}


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
    n, f = e["n_experts"], e["d_expert"]
    out += [(("ffn", "router", "w"), lead + (d, n), "linear", "float32"),
            (("ffn", "router", "bias"), lead + (n,), "bias", "float32"),
            (("ffn", "experts", "gate"), lead + (n, d, f), "linear"),
            (("ffn", "experts", "up"), lead + (n, d, f), "linear"),
            (("ffn", "experts", "down"), lead + (n, f, d), "linear")]
    if e["n_shared"]:
        fs = f * e["n_shared"]
        out += [(("ffn", "shared", "gate", "w"), lead + (d, fs), "linear"),
                (("ffn", "shared", "up", "w"), lead + (d, fs), "linear"),
                (("ffn", "shared", "down", "w"), lead + (fs, d), "linear")]
    return out


def leaves(cfg: dict) -> list[tuple]:
    """Every parameter of the port's ``init_lm`` tree: (path, shape, init)
    or (path, shape, init, dtype), the layers of each stack stacked along
    a leading dim."""
    L, d, V = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
    dense = min(DENSE_PREFIX.get(cfg["name"].removesuffix("-smoke"), 0),
                max(L - 1, 0))
    stacks = ([(dense, False)] if dense else []) + [(L - dense, True)]
    out = [(("embed", "table"), (V, d), "embed")]
    for i, (n, moe) in enumerate(stacks):
        out += [(("stacks", i) + p, shape, *rest)
                for p, shape, *rest in _block(cfg, (n,), moe)]
    out.append((("final_norm", "scale"), (d,), "norm"))
    if not cfg["tie_embeddings"]:
        out.append((("head", "table"), (V, d), "embed"))
    if cfg["mtp_heads"]:
        out += [(("mtp", "proj", "w"), (2 * d, d), "linear"),
                (("mtp", "norm", "scale"), (d,), "norm")]
        out += [(("mtp", "block") + p, shape, *rest)
                for p, shape, *rest in _block(cfg, (), True)]
    return out
