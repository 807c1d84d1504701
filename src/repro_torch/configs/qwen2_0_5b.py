"""Qwen2-0.5B. [arXiv:2407.10671; hf]

Assigned: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936 — GQA,
QKV bias.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    max_seq_len=131072,
    source="arXiv:2407.10671; hf",
)

SMOKE = ModelConfig(
    name="qwen2-0.5b-smoke",
    family="dense",
    n_layers=2,
    d_model=56,            # 4 heads × 14
    n_heads=4,
    n_kv_heads=2,
    d_head=14,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    tie_embeddings=True,
    max_seq_len=128,
    source="smoke",
)
