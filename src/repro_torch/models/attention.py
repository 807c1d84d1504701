"""Attention pieces the dense export and init need: the causal window mask
and the GQA projection params (the JAX package's ``models/attention.py``
holds the full prefill/decode paths, which the model facade's port will
bring)."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .layers import init_linear

NEG_INF = -1e30


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: int | None) -> torch.Tensor:
    """[qs, ks] boolean: causal AND within window (window=None → pure causal)."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def init_gqa(generator: torch.Generator, cfg: ModelConfig, *,
             device: torch.device | str, lead: tuple[int, ...] = ()) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = {"device": device, "lead": lead}
    return {
        "wq": init_linear(generator, d, h * hd, cfg.qkv_bias, cfg.dtype, **kw),
        "wk": init_linear(generator, d, kvh * hd, cfg.qkv_bias, cfg.dtype, **kw),
        "wv": init_linear(generator, d, kvh * hd, cfg.qkv_bias, cfg.dtype, **kw),
        "wo": init_linear(generator, h * hd, d, False, cfg.dtype, **kw),
    }
