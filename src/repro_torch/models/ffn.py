"""Feed-forward params: the dense SwiGLU / GELU MLP (Mixture-of-Experts is
not ported yet, ROADMAP A6)."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .layers import init_linear


def init_mlp(generator: torch.Generator, d: int, d_ff: int, act: str,
             dtype: torch.dtype = torch.bfloat16, *,
             device: torch.device | str, lead: tuple[int, ...] = ()) -> dict:
    kw = {"device": device, "lead": lead}
    if act == "swiglu":
        return {
            "gate": init_linear(generator, d, d_ff, False, dtype, **kw),
            "up": init_linear(generator, d, d_ff, False, dtype, **kw),
            "down": init_linear(generator, d_ff, d, False, dtype, **kw),
        }
    return {
        "up": init_linear(generator, d, d_ff, False, dtype, **kw),
        "down": init_linear(generator, d_ff, d, False, dtype, **kw),
    }


def init_ffn(generator: torch.Generator, cfg: ModelConfig, *,
             device: torch.device | str, lead: tuple[int, ...] = ()) -> dict:
    if cfg.moe is not None:
        raise NotImplementedError("MoE FFN is not ported yet (ROADMAP A6)")
    return init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, cfg.dtype,
                    device=device, lead=lead)
