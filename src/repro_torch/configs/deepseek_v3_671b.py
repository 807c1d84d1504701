"""DeepSeek-V3 671B. [arXiv:2412.19437; hf]

Assigned: 61L d_model=7168 128H (GQA kv=128) d_ff=2048 vocab=129280,
MoE 256e top-8 — MLA, 1 shared + 256 routed top-8, MTP.
First 3 layers dense (HF config first_k_dense_replace=3).
"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,            # dense-prefix layers
    vocab_size=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  capacity_factor=1.25, router_aux_free=True,
                  dense_prefix=3),
    mtp_heads=1,
    rope_theta=1e4,
    max_seq_len=131072,
    source="arXiv:2412.19437; hf",
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke",
    family="moe",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                  capacity_factor=1.5, router_aux_free=True,
                  dense_prefix=3),
    mtp_heads=1,
    max_seq_len=128,
    source="smoke",
)
