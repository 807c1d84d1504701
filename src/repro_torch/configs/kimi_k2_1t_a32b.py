"""Kimi K2 — trillion-param MoE. [arXiv:2501.kimi2; unverified]

Assigned: 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840,
MoE 384e top-8 (+1 shared expert, first layer dense — K2 follows the
DeepSeek-V3 layout per its tech report).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=112,
    d_ff=18432,            # dense-prefix layer FFN (DSv3-style wide dense layer)
    vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, n_shared=1,
                  capacity_factor=1.25, router_aux_free=True,
                  dense_prefix=1),
    rope_theta=5e4,
    max_seq_len=131072,
    source="arXiv:2501.kimi2; unverified",
)

SMOKE = ModelConfig(
    name="kimi-k2-1t-a32b-smoke",
    family="moe",
    n_layers=3,            # 1 dense prefix + 2 MoE
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                  capacity_factor=1.5, router_aux_free=True,
                  dense_prefix=1),
    max_seq_len=128,
    source="smoke",
)
