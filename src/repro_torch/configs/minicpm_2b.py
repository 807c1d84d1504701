"""MiniCPM-2B. [arXiv:2404.06395; hf]

Assigned: 40L d_model=2304 36H (kv=36, MHA) d_ff=5760 vocab=122753 —
WSD schedule (arch = llama-like); depth-scaled residuals
(scale_depth=1.4 → residual_scale = 1.4/sqrt(40)).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    residual_scale=1.4 / 40 ** 0.5,
    tie_embeddings=True,
    rope_theta=1e4,
    max_seq_len=131072,
    source="arXiv:2404.06395; hf",
)

SMOKE = ModelConfig(
    name="minicpm-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=72,
    n_heads=4,
    n_kv_heads=4,
    d_ff=144,
    vocab_size=257,
    residual_scale=1.4 / 2 ** 0.5,
    tie_embeddings=True,
    max_seq_len=128,
    source="smoke",
)
