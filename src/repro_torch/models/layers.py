"""Primitive layers: norms, linear, embedding.

Pure-functional like the JAX package's ``models/layers.py``: ``init_*``
returns a param tree (dict of tensors), ``apply`` style functions take
(params, x).  ``init_*`` draw from a ``torch.Generator`` on an explicit
``device`` (the CUDA card unless the caller passes ``"cpu"``); ``lead``
prepends dimensions, which is how a stack of layers is drawn at once.
Norms compute their statistics in fp32 and keep activations in the input
dtype.  The JAX package's RoPE helpers are not ported: the exported graph
applies no rotary embedding (ROADMAP queue C).
"""
from __future__ import annotations

import torch


def check_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on; raises for CUDA without a card
    (entry points never fall back to the CPU on their own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return device


def _normal(generator: torch.Generator, shape: tuple[int, ...], scale: float,
            dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def init_linear(generator: torch.Generator, d_in: int, d_out: int,
                bias: bool = False, dtype: torch.dtype = torch.bfloat16,
                scale: float | None = None, *, device: torch.device | str,
                lead: tuple[int, ...] = ()) -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    device = check_device(device)
    p = {"w": _normal(generator, lead + (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=device)
    return p


def init_norm(d: int, kind: str = "rmsnorm",
              dtype: torch.dtype = torch.bfloat16, *,
              device: torch.device | str,
              lead: tuple[int, ...] = ()) -> dict:
    device = check_device(device)
    p = {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    return p


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def apply_norm(p: dict, x: torch.Tensor, kind: str = "rmsnorm") -> torch.Tensor:
    return layernorm(p, x) if kind == "layernorm" else rmsnorm(p, x)


def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype = torch.bfloat16, *,
                   device: torch.device | str) -> dict:
    return {"table": _normal(generator, (vocab, d), 0.02, dtype,
                             check_device(device))}
