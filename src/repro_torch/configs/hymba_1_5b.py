"""Hymba-1.5B. [arXiv:2411.13676; hf]

Assigned: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — PARALLEL attention + mamba heads per layer; sliding-window
attention everywhere except 3 global-attention layers (first/middle/last);
128 learnable meta tokens.  Sub-quadratic → runs long_500k.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab_size=32001,
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
    window=1024,
    global_layers=(0, 15, 31),
    meta_tokens=128,
    tie_embeddings=True,
    rope_theta=1e4,
    max_seq_len=524288 + 128,
    source="arXiv:2411.13676; hf",
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    ssm=SSMConfig(state_dim=4, conv_dim=4, expand=2),
    window=8,
    global_layers=(0, 2),
    meta_tokens=4,
    tie_embeddings=True,
    max_seq_len=256,
    source="smoke",
)
