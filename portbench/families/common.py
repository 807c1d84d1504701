"""Arithmetic shared by the families' counts.

A weight product is ``(name, m, k, n)``: an ``[m, k]`` activation times a
``[k, n]`` weight, made once per forward for every layer it is listed
for.  Its least time on the card is the larger of its operations over the
peak rate and its bytes over the memory bandwidth, the bytes counting the
weight, the input and the output once each in the served dtype.
"""
from __future__ import annotations

import json
import pathlib

PEAKS = json.loads((pathlib.Path(__file__).resolve().parent.parent
                    / "yardstick" / "peaks.json").read_text())
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def product_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def product_bytes(m: int, k: int, n: int, dtype: str) -> int:
    return (k * n + m * k + m * n) * DTYPE_BYTES[dtype]


def least_seconds(products, dtype: str, peaks: dict = PEAKS) -> float:
    """The least time of ``products`` on the card, each bound by the
    larger of its operations and its bytes."""
    return sum(max(product_flops(m, k, n) / peaks["bf16_flops"],
                   product_bytes(m, k, n, dtype) / peaks["hbm_bytes_per_s"])
               for _, m, k, n in products)


def causal_pairs(seq: int, window: int | None) -> int:
    """(query, key) pairs a causal attention over ``seq`` positions keeps,
    each query seeing at most ``window`` keys (itself included)."""
    if window is None or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def attention_flops(cfg: dict, batch: int, seq: int,
                    window: int | None) -> int:
    """Scores and context of one layer over its kept pairs: 2 · 2 · pairs
    · d_head a head."""
    return (4 * batch * cfg["n_heads"] * causal_pairs(seq, window)
            * cfg["d_head"])


def head_product(cfg: dict, rows: int):
    return ("head", rows, cfg["d_model"], cfg["vocab_size"])
