"""A Hymba-style hybrid decoder (attention ∥ a Mamba head a layer): the
port's parameter layout and the benchmark's own counts of a forward's
work."""
from __future__ import annotations

from portbench.families import dense
from portbench.families.common import (attention_flops, head_product,
                                      product_flops)

# operations of the selective scan per (position, channel, state): the
# decay's argument and exp, h's multiply-add and the input's multiply, and
# y's multiply-add
SCAN_OPS = 7


def _widths(cfg: dict) -> tuple[int, int]:
    ssm = cfg["ssm"]
    return ssm["expand"] * cfg["d_model"], ssm["state_dim"]


def leaves(cfg: dict) -> list[tuple[tuple, tuple, str]]:
    L, d = cfg["n_layers"], cfg["d_model"]
    di, n = _widths(cfg)
    m = ("stacks", 0, "mamba")
    return dense.leaves(cfg) + [
        (m + ("in_proj", "w"), (L, d, 2 * di), "linear"),
        (m + ("conv_w",), (L, cfg["ssm"]["conv_dim"], di), "conv"),
        (m + ("x_proj", "w"), (L, di, 2 * n + 1), "linear"),
        (m + ("a_log",), (L, di, n), "a_log"),
        (m + ("d_skip",), (L, di), "d_skip"),
        (m + ("out_proj", "w"), (L, di, cfg["d_model"]), "linear"),
    ]


def products(cfg: dict, batch: int, seq: int):
    rows = batch * seq
    di, n = _widths(cfg)
    per_layer = dense.layer_products(cfg, rows) + [
        ("mamba_in", rows, cfg["d_model"], 2 * di),
        ("mamba_xproj", rows, di, 2 * n + 1),
        ("mamba_out", rows, di, cfg["d_model"])]
    return per_layer * cfg["n_layers"] + [head_product(cfg, rows)]


def model_flops(cfg: dict, batch: int, seq: int) -> int:
    """Weight products, attention over each layer's kept pairs, the
    causal convolution and the selective scan."""
    di, n = _widths(cfg)
    rows = batch * seq
    attn = sum(attention_flops(
        cfg, batch, seq, None if i in cfg["global_layers"] else cfg["window"])
        for i in range(cfg["n_layers"]))
    mixer = cfg["n_layers"] * rows * di * (2 * cfg["ssm"]["conv_dim"]
                                           + SCAN_OPS * n)
    return (sum(product_flops(m, k, nn) for _, m, k, nn in
                products(cfg, batch, seq)) + attn + mixer)
