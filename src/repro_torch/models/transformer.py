"""Layer-stack metadata and the dense LM's parameter init.

The tree layout is the JAX package's ``init_lm``: ``{"embed": {"table"},
"stacks": [per-stack params with leading dim L], "final_norm": {"scale"}}``
(plus ``"head"`` when embeddings are untied), so a reference param tree
converted by :mod:`repro_torch.bridge` and this init are interchangeable.
Only dense stacks are ported; the other families raise.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .attention import init_gqa
from .ffn import init_ffn
from .layers import check_device, init_embedding, init_norm


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, int]]:
    """[(kind, n_layers)] groups executed in order (dense-prefix before MoE)."""
    if cfg.family == "ssm":
        return [("rwkv", cfg.n_layers)]
    if cfg.family == "hybrid":
        return [("hybrid", cfg.n_layers)]
    if cfg.moe is not None:
        prefix = cfg_dense_prefix(cfg)
        groups = []
        if prefix:
            groups.append(("dense_prefix", prefix))
        groups.append(("moe", cfg.n_layers - prefix))
        return groups
    return [("dense", cfg.n_layers)]


def cfg_dense_prefix(cfg: ModelConfig) -> int:
    """DeepSeek-V3: first 3 layers dense; Kimi-K2: first layer dense."""
    name = cfg.name.removesuffix("-smoke")
    prefix = {"deepseek-v3-671b": 3, "kimi-k2-1t-a32b": 1}.get(name, 0)
    return min(prefix, max(cfg.n_layers - 1, 0))


def window_for_layer(cfg: ModelConfig, global_index: int) -> int:
    """0 means no window (full attention)."""
    if cfg.window is None:
        return 0
    if global_index in cfg.global_layers:
        return 0
    return cfg.window


def stack_meta(cfg: ModelConfig) -> list[tuple[str, int, tuple[int, ...]]]:
    """Static metadata per stack: (kind, n_layers, window_sizes)."""
    out = []
    base = 0
    for kind, n in layer_kinds(cfg):
        windows = tuple(window_for_layer(cfg, base + i) for i in range(n))
        out.append((kind, n, windows))
        base += n
    return out


def init_block(generator: torch.Generator, cfg: ModelConfig, layer_kind: str,
               *, device: torch.device | str,
               lead: tuple[int, ...] = ()) -> dict:
    """Params of ``lead`` stacked blocks of ``layer_kind`` (dense only)."""
    if layer_kind != "dense" or cfg.mla is not None:
        raise NotImplementedError(
            f"{layer_kind!r} blocks of {cfg.name} are not ported yet "
            "(ROADMAP A6)")
    kw = {"device": device, "lead": lead}
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, cfg.dtype, **kw),
        "attn": init_gqa(generator, cfg, **kw),
        "norm2": init_norm(cfg.d_model, cfg.norm, cfg.dtype, **kw),
        "ffn": init_ffn(generator, cfg, **kw),
    }


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device: torch.device | str = "cuda") -> dict:
    """Random dense-LM params on ``device`` drawn from ``generator`` (which
    must live on that device).  Scales follow the JAX package: linear
    weights ``d_in**-0.5``, embeddings ``0.02``, zero biases, unit norms."""
    device = check_device(device)
    if cfg.meta_tokens or cfg.mtp_heads or cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name} is not a plain dense LM; not "
                                  "ported yet (ROADMAP A6)")
    p = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                cfg.dtype, device=device),
        "stacks": [init_block(generator, cfg, kind, device=device, lead=(n,))
                   for kind, n, _ in stack_meta(cfg)],
        "final_norm": init_norm(cfg.d_model, cfg.norm, cfg.dtype,
                                device=device),
    }
    if not cfg.tie_embeddings:
        p["head"] = init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                   cfg.dtype, device=device)
    return p
