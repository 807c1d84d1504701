"""A dense decoder (GLM-4): the port's parameter layout and the
benchmark's own counts of a forward's work."""
from __future__ import annotations

from portbench.families.common import (attention_flops, head_product,
                                      product_flops)


def leaves(cfg: dict) -> list[tuple[tuple, tuple, str]]:
    """Every parameter of the port's layout: (path, shape, init), with the
    layers of the one stack stacked along a leading dim."""
    L, d, V = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
    hq = cfg["n_heads"] * cfg["d_head"]
    hkv = cfg["n_kv_heads"] * cfg["d_head"]
    f = cfg["d_ff"]
    out = [(("embed", "table"), (V, d), "embed")]
    s = ("stacks", 0)
    out += [(s + ("norm1", "scale"), (L, d), "norm")]
    for name, width in (("wq", hq), ("wk", hkv), ("wv", hkv)):
        out.append((s + ("attn", name, "w"), (L, d, width), "linear"))
        if cfg["qkv_bias"]:
            out.append((s + ("attn", name, "b"), (L, width), "bias"))
    out += [(s + ("attn", "wo", "w"), (L, hq, d), "linear"),
            (s + ("norm2", "scale"), (L, d), "norm"),
            (s + ("ffn", "gate", "w"), (L, d, f), "linear"),
            (s + ("ffn", "up", "w"), (L, d, f), "linear"),
            (s + ("ffn", "down", "w"), (L, f, d), "linear"),
            (("final_norm", "scale"), (d,), "norm")]
    if not cfg["tie_embeddings"]:
        out.append((("head", "table"), (V, d), "embed"))
    return out


def layer_products(cfg: dict, rows: int) -> list[tuple[str, int, int, int]]:
    d, f = cfg["d_model"], cfg["d_ff"]
    hq = cfg["n_heads"] * cfg["d_head"]
    hkv = cfg["n_kv_heads"] * cfg["d_head"]
    return [("wq", rows, d, hq), ("wk", rows, d, hkv), ("wv", rows, d, hkv),
            ("wo", rows, hq, d), ("gate", rows, d, f), ("up", rows, d, f),
            ("down", rows, f, d)]


def products(cfg: dict, batch: int, seq: int):
    """Every weight product of one forward."""
    rows = batch * seq
    return (layer_products(cfg, rows) * cfg["n_layers"]
            + [head_product(cfg, rows)])


def model_flops(cfg: dict, batch: int, seq: int) -> int:
    """The forward's model operations: its weight products and its
    attention over the causal pairs."""
    return (sum(product_flops(m, k, n) for _, m, k, n in
                products(cfg, batch, seq))
            + cfg["n_layers"] * attention_flops(cfg, batch, seq, None))
