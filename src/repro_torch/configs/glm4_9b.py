"""GLM-4 9B. [hf:THUDM/glm-4-9b; hf]

Assigned: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552 — RoPE, GQA.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    qkv_bias=True,         # GLM-4 uses attention QKV bias
    rope_theta=1e4,
    max_seq_len=131072,
    source="hf:THUDM/glm-4-9b; hf",
)

SMOKE = ModelConfig(
    name="glm4-9b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    qkv_bias=True,
    max_seq_len=128,
    source="smoke",
)
