"""Primitive layers: norms, linear, embedding, RoPE.

Pure-functional like the JAX package's ``models/layers.py``: ``init_*``
returns a param tree (dict of tensors), ``apply`` style functions take
(params, x).  ``init_*`` draw from a ``torch.Generator`` on an explicit
``device`` (the CUDA card unless the caller passes ``"cpu"``); ``lead``
prepends dimensions, which is how a stack of layers is drawn at once.
Matmuls accumulate in fp32 and round once to the activation dtype; norms
compute their statistics in fp32.  The model facade applies RoPE; the
exported operator graph does not, as the JAX package's does not (ROADMAP
C5), except in its MLA payloads.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from ..utils import shard
from ..utils.sharding_ctx import on_local_shards, whole


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
    y = matmul(x, p["w"])
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
    and rounds once.  An fp32 ``a`` (a sharded activation whose grad is
    summed across ranks in fp32) is taken in ``b``'s dtype, which holds
    its values, and its grad is left in fp32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.grad_f32 = a.dtype != b.dtype
        a = a.to(b.dtype)
        ctx.save_for_backward(a, b)
        return _mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            bt = b.transpose(-1, -2)
            da = (_mm(g, bt, out_dtype=torch.float32) if ctx.grad_f32
                  else g @ bt)
        if ctx.needs_input_grad[1]:
            db = a.transpose(-1, -2) @ g
        return da, db


def _mm(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    return (torch.bmm if a.dim() == 3 else torch.mm)(a, b, **kw)


def _matmul_f32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda and b.dtype != torch.float32:
        return _MatmulF32.apply(a, b)
    return torch.matmul(a.float(), b.float())


def _rows_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [..., k] @ b [k, n]`` with an fp32 result (a's leading dims as
    rows, so the card's ``_MatmulF32`` takes any rank of ``a``)."""
    y = _matmul_f32_plain(a.reshape(-1, a.shape[-1]), b)
    return y.reshape(*a.shape[:-1], b.shape[-1])


def _product_spec(a: torch.Tensor, b: torch.Tensor) -> str:
    """``a @ b`` in einsum notation: ``a [..., k]`` with ``b [k, n]``, or
    batched with ``b [lead..., k, n]`` on ``a``'s leading dims."""
    lead = "abcdefgh"[:a.dim() - 1]
    return f"{lead}k,{lead[:b.dim() - 2]}kn->{lead}n"


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the operands' dtype (fp32 accumulation, one rounding).
    ``DTensor`` operands run on each rank's local shards; where the
    contraction is split (a row-parallel product), each rank's partial
    product is kept in fp32 and summed across ranks before the one
    rounding, as the reference's ``preferred_element_type=float32`` dot
    under GSPMD; so is ``a``'s grad where it is such a sum (the backward
    of a column-parallel product)."""
    if not (isinstance(a, DTensor) or isinstance(b, DTensor)):
        return torch.matmul(a, b)
    f32 = _rows_f32 if b.dim() == 2 else _matmul_f32_plain

    def local(x, y):
        return torch.matmul(x, y) if x.dtype == y.dtype else f32(x, y)
    return on_local_shards(local, _product_spec(a, b), a, b, fn_partial=f32,
                           f32_grads=(0,), dtype=a.dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D or 3-D operands, accumulated in fp32 with an fp32
    result, differentiable; on the card no fp32 copy of either operand is
    made (a Kimi-K2 expert stack is 5.6 GB in bf16, 11.3 GB in fp32).
    ``DTensor`` operands run on each rank's local shards in their own
    dtype, a split contraction, and ``a``'s grad where it is a sum across
    ranks, summed in fp32."""
    if isinstance(a, DTensor) or isinstance(b, DTensor):
        return on_local_shards(_matmul_f32_plain, _product_spec(a, b), a, b,
                               fn_partial=_matmul_f32_plain, f32_grads=(0,))
    return _matmul_f32_plain(a, b)


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits head (optionally tied): [..., d] → [..., vocab] in fp32, the
    products accumulated in fp32 and never rounded to the table's dtype."""
    table = p["table"]
    y = matmul_f32(x.reshape(-1, x.shape[-1]), table.t())
    return y.reshape(*x.shape[:-1], table.shape[0])


# -- RoPE ---------------------------------------------------------------------

def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's attention scale for a context stretched by ``factor``:
    ``0.1 · mscale · ln(factor) + 1`` (DeepSeek-V3's
    ``yarn_get_mscale``)."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_correction_range(beta_fast: float, beta_slow: float, d_head: int,
                          theta: float, original: int) -> tuple[int, int]:
    """The rotary dims, of ``d_head / 2``, between the one that turns
    ``beta_fast`` times and the one that turns ``beta_slow`` times over the
    ``original`` context (DeepSeek-V3's ``yarn_find_correction_range``)."""
    def dim(rotations: float) -> float:
        return (d_head * math.log(original / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    return (max(math.floor(dim(beta_fast)), 0),
            min(math.ceil(dim(beta_slow)), d_head - 1))


def yarn_ramp(low: float, high: float, n: int,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """0 up to ``low``, 1 from ``high``, linear between, over ``n`` dims
    (DeepSeek-V3's ``yarn_linear_ramp_mask``)."""
    if low == high:
        high += 0.001
    ramp = (torch.arange(n, dtype=torch.float32, device=device) - low) \
        / (high - low)
    return torch.clamp(ramp, 0, 1)


def rope_freqs(d_head: int, theta: float,
               device: torch.device | str = "cpu",
               scaling: Any = None) -> torch.Tensor:
    """RoPE's inverse frequencies; with YaRN ``scaling`` the dims past the
    correction range are divided by its factor, those below it kept, and
    those inside ramped between."""
    freqs = 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                          device=device) / d_head))
    if scaling is None:
        return freqs
    low, high = yarn_correction_range(
        scaling.beta_fast, scaling.beta_slow, d_head, theta,
        scaling.original_max_position_embeddings)
    keep = 1 - yarn_ramp(low, high, d_head // 2, device)
    return freqs / scaling.factor * (1 - keep) + freqs * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4, scaling: Any = None) -> torch.Tensor:
    """x: [..., seq, heads, d_head]; positions: [..., seq] (int).  The two
    halves of the last dim are the pairs rotated together.  With YaRN
    ``scaling`` the frequencies are YaRN's and cos / sin are scaled by
    mscale(factor, mscale) / mscale(factor, mscale_all_dim)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device, scaling)         # [d/2]
    angles = positions[..., None].float() * freqs           # [..., seq, d/2]
    cos = torch.cos(angles)[..., None, :]                   # [..., seq, 1, d/2]
    sin = torch.sin(angles)[..., None, :]
    if scaling is not None:
        attn = (yarn_mscale(scaling.factor, scaling.mscale)
                / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
        if attn != 1.0:
            cos, sin = cos * attn, sin * attn
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")
