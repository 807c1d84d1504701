"""Architecture registry: one module per ported architecture.

    from repro_torch.configs import get_config, list_archs
    cfg = get_config("qwen2-0.5b")           # full production config
    cfg = get_config("qwen2-0.5b", smoke=True)

Every architecture of the JAX package is registered.
"""
from __future__ import annotations

import importlib

from .base import (
    FrontendConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ParallelConfig,
    SHAPES,
    ShapeCell,
    SSMConfig,
    cell_applicable,
)

_ARCH_MODULES = {
    "qwen2-0.5b": "qwen2_0_5b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "llama3.2-1b": "llama3_2_1b",
    "minicpm-2b": "minicpm_2b",
    "glm4-9b": "glm4_9b",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-medium": "whisper_medium",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_ARCH_MODULES)}")
    mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = [
    "FrontendConfig", "MLAConfig", "ModelConfig", "MoEConfig", "ParallelConfig",
    "SHAPES", "ShapeCell", "SSMConfig", "cell_applicable",
    "get_config", "list_archs",
]
