"""Plain float32 pieces shared by the families' references.

Every product goes through :func:`mm`, which computes in float32 with TF32
off, or, for the control (``quant="fp8"``), rounds both operands to
float8 e4m3 first, each row of the left operand and each column of the
right one scaled to the format's range: the reference computed one
precision below the configuration's bfloat16.  Nothing here imports the
program.
"""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0     # the largest finite float8 e4m3 value


@contextlib.contextmanager
def exact_fp32():
    """float32 products with TF32 off, the flags restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, scaled by its largest magnitude along
    ``dim``, back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def mm(a: torch.Tensor, b: torch.Tensor, quant: str | None) -> torch.Tensor:
    """``a [..., k] @ b [..., k, n]`` in float32 (operands in fp8 first
    under ``quant="fp8"``)."""
    if quant == "fp8":
        a, b = fp8(a, -1), fp8(b, -2)
    elif quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return torch.matmul(a, b)


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def linear(x: torch.Tensor, p: dict, quant: str | None) -> torch.Tensor:
    y = mm(x, f32(p["w"]), quant)
    if "b" in p:
        y = y + f32(p["b"])
    return y


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * f32(scale)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int | None, quant: str | None) -> torch.Tensor:
    """Causal grouped-query attention, optionally within a window of
    ``window`` positions.  q [B,S,H,D]; k, v [B,S,KVH,D] → [B,S,H·D]."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    q = q.permute(0, 2, 1, 3)                                  # [B,H,S,D]
    k = k.permute(0, 2, 1, 3).repeat_interleave(h // kvh, dim=1)
    v = v.permute(0, 2, 1, 3).repeat_interleave(h // kvh, dim=1)
    scores = mm(q, k.transpose(-1, -2), quant) * d ** -0.5     # [B,H,S,S]
    pos = torch.arange(s, device=q.device)
    keep = pos[None, :] <= pos[:, None]
    if window is not None:
        keep &= pos[None, :] > pos[:, None] - window
    scores = scores.masked_fill(~keep, float("-inf"))
    ctx = mm(torch.softmax(scores, dim=-1), v, quant)          # [B,H,S,D]
    return ctx.permute(0, 2, 1, 3).reshape(b, s, h * d)


def swiglu(x: torch.Tensor, p: dict, quant: str | None) -> torch.Tensor:
    g = linear(x, p["gate"], quant)
    return linear(torch.nn.functional.silu(g) * linear(x, p["up"], quant),
                  p["down"], quant)


def layer(tree, i: int):
    """Layer ``i`` of a tree of stacked ``[L, ...]`` leaves."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def logits(cfg: dict, w: dict, h: torch.Tensor,
           quant: str | None) -> torch.Tensor:
    """The head over final-normed hidden states ``h [..., d]``: logits in
    float32."""
    table = w["embed" if cfg["tie_embeddings"] else "head"]["table"]
    return mm(h, f32(table).t(), quant)
