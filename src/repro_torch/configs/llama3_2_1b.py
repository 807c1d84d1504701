"""Llama-3.2-1B. [hf:meta-llama/Llama-3.2-1B; unverified]

Assigned: 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,   # Llama-3.2-1B ties the LM head
    rope_theta=5e5,
    max_seq_len=131072,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    tie_embeddings=True,
    max_seq_len=128,
    source="smoke",
)
