"""LLaVA-NeXT (Mistral-7B backbone). [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Assigned: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000 — anyres
tiling.  The vision tower is a STUB: the caller provides precomputed CLIP
patch embeddings (anyres: base 576 + 4 tiles × 576 = 2880 patches, feat
1024); the 2-layer MLP projector to d_model IS implemented.
"""
from .base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    frontend=FrontendConfig(kind="vision", n_tokens=2880, feat_dim=1024),
    rope_theta=1e6,
    max_seq_len=131072,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)

SMOKE = ModelConfig(
    name="llava-next-mistral-7b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    frontend=FrontendConfig(kind="vision", n_tokens=8, feat_dim=24),
    max_seq_len=128,
    source="smoke",
)
