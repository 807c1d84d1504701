"""Whisper-medium. [arXiv:2212.04356; unverified]

Assigned: 24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865 — enc-dec,
conv frontend STUB (input_specs provides precomputed frame embeddings:
1500 frames × 80-mel→conv stub feature dim).
"""
from .base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,           # encoder depth
    n_dec_layers=24,       # decoder depth
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    rope=False,            # learned positional embeddings
    tie_embeddings=True,
    frontend=FrontendConfig(kind="audio", n_tokens=1500, feat_dim=1024),
    max_seq_len=32768,     # assigned decode shapes exceed the 448 original
    source="arXiv:2212.04356; unverified",
)

SMOKE = ModelConfig(
    name="whisper-medium-smoke",
    family="encdec",
    n_layers=2,
    n_dec_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    norm="layernorm",
    act="gelu",
    rope=False,
    tie_embeddings=True,
    frontend=FrontendConfig(kind="audio", n_tokens=16, feat_dim=24),
    max_seq_len=64,
    source="smoke",
)
