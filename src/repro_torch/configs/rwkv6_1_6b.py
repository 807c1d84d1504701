"""RWKV-6 (Finch) 1.6B. [arXiv:2404.05892; unverified]

Assigned: 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536 —
data-dependent decay.  Head size 64 → 32 heads.  Sub-quadratic → runs
long_500k (state is O(1) in sequence length).
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # d_model / head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    ssm=SSMConfig(head_dim=64),
    rope=False,
    max_seq_len=1 << 20,
    source="arXiv:2404.05892; unverified",
)

SMOKE = ModelConfig(
    name="rwkv6-1.6b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm=SSMConfig(head_dim=16),
    rope=False,
    max_seq_len=256,
    source="smoke",
)
