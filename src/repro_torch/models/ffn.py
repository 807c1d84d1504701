"""Feed-forward: the dense SwiGLU / GELU MLP (Mixture-of-Experts is not
ported yet, ROADMAP A6)."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .layers import gelu, init_linear, linear


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


def mlp(p: dict, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    if "gate" in p:
        h = torch.nn.functional.silu(linear(p["gate"], x)) * linear(p["up"], x)
    else:
        h = gelu(linear(p["up"], x))
    return linear(p["down"], h)


def ffn(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Dense FFN → (out, aux metrics); MoE raises."""
    if cfg.moe is not None:
        raise NotImplementedError("MoE FFN is not ported yet (ROADMAP A6)")
    return mlp(p, x, cfg.act), {}
