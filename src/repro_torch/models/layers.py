"""Primitive layers: norms, linear, embedding, RoPE.

Pure-functional like the JAX package's ``models/layers.py``: ``init_*``
returns a param tree (dict of tensors), ``apply`` style functions take
(params, x).  ``init_*`` draw from a ``torch.Generator`` on an explicit
``device`` (the CUDA card unless the caller passes ``"cpu"``); ``lead``
prepends dimensions, which is how a stack of layers is drawn at once.
Matmuls accumulate in fp32 and round once to the activation dtype; norms
compute their statistics in fp32.  The model facade applies RoPE; the
exported operator graph does not, as the JAX package's does not (ROADMAP
C5).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ..utils import shard
from ..utils.sharding_ctx import whole


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


def apply_norm(p: dict, x: torch.Tensor, kind: str = "rmsnorm",
               use_kernels: bool = False) -> torch.Tensor:
    """``use_kernels`` routes RMSNorm through the port's kernel (the same
    function as :func:`rmsnorm`); LayerNorm has no kernel and stays plain."""
    if kind == "layernorm":
        return layernorm(p, x)
    if use_kernels:
        from ..kernels.rmsnorm import rmsnorm as rmsnorm_kernel
        return rmsnorm_kernel(x, p["scale"])
    return rmsnorm(p, x)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w (fp32 accumulation, one rounding to x's dtype), then + b."""
    y = torch.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype = torch.bfloat16, *,
                   device: torch.device | str) -> dict:
    return {"table": _normal(generator, (vocab, d), 0.02, dtype,
                             check_device(device))}


def embed(p: dict, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table.  A ``DTensor`` table is read whole with whole
    ids, then laid out by the rules (torch 2.11's ``DTensor`` cannot
    propagate the backward of a gather with split ids)."""
    table = p["table"]
    if isinstance(table, DTensor):
        return shard(whole(table)[whole(ids)], "batch", "seq", "embed")
    return shard(table[ids], "batch", "seq", "embed")


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` (2-D or batched 3-D) with an fp32 result from
    low-precision operands on the card (``out_dtype=float32``, no fp32 copy
    of either operand), and its backward in the operands' dtype: the fp32
    output grads are rounded to it, and each product accumulates in fp32
    and rounds once."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = g @ b.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        db = a.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D or 3-D operands, accumulated in fp32 with an fp32
    result, differentiable; on the card no fp32 copy of either operand is
    made (a Kimi-K2 expert stack is 5.6 GB in bf16, 11.3 GB in fp32),
    except for a ``DTensor`` operand: ``DTensor`` has no sharding rule for
    a product with ``out_dtype``, so it takes the fp32 copies."""
    if (a.is_cuda and a.dtype != torch.float32
            and not isinstance(a, DTensor)):
        return _MatmulF32.apply(a, b)
    return torch.matmul(a.float(), b.float())


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits head (optionally tied): [..., d] → [..., vocab] in fp32, the
    products accumulated in fp32 and never rounded to the table's dtype."""
    table = p["table"]
    y = matmul_f32(x.reshape(-1, x.shape[-1]), table.t())
    return y.reshape(*x.shape[:-1], table.shape[0])


# -- RoPE ---------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: [..., seq, heads, d_head]; positions: [..., seq] (int)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # [d/2]
    angles = positions[..., None].float() * freqs           # [..., seq, d/2]
    cos = torch.cos(angles)[..., None, :]                   # [..., seq, 1, d/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")
