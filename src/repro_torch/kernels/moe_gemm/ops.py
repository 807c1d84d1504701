"""Public wrapper of the grouped expert SwiGLU MLP.

CPU tensors take the plain version (``ref.py``).  CUDA tensors launch the
kernel or raise: any E, C >= 0, d and f are taken (the kernel masks every
edge).  ``launches`` counts wrapper calls that launched the kernel (its two
stages count as one).
"""
from __future__ import annotations

import torch

from .. import use_kernel
from .kernel import _ENTRY, moe_mlp_cuda
from .ref import moe_mlp_ref

launches = 0
_GRID_LIMIT = 65535     # blockIdx.y (experts)


def moe_mlp(buf: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
            down: torch.Tensor) -> torch.Tensor:
    """buf: [E,C,d]; gate/up: [E,d,f]; down: [E,f,d] → [E,C,d]."""
    global launches
    if buf.dim() != 3 or gate.dim() != 3:
        raise ValueError(f"moe_mlp wants buf [E,C,d] and weights [E,d,f], "
                         f"got {tuple(buf.shape)}, {tuple(gate.shape)}")
    e, c, d = buf.shape
    f = gate.shape[-1]
    if (tuple(gate.shape) != (e, d, f) or tuple(up.shape) != (e, d, f)
            or tuple(down.shape) != (e, f, d)):
        raise ValueError(f"moe_mlp shape mismatch: buf {tuple(buf.shape)}, "
                         f"gate {tuple(gate.shape)}, up {tuple(up.shape)}, "
                         f"down {tuple(down.shape)}")
    if not use_kernel(buf, gate, up, down):
        return moe_mlp_ref(buf, gate, up, down)
    if not (buf.dtype == gate.dtype == up.dtype == down.dtype) \
            or buf.dtype not in _ENTRY:
        raise TypeError(f"moe_mlp takes bf16 or fp32 operands of one dtype, "
                        f"got {buf.dtype}, {gate.dtype}, {up.dtype}, "
                        f"{down.dtype}")
    if not all(t.is_contiguous() for t in (buf, gate, up, down)):
        raise ValueError("moe_mlp needs contiguous operands")
    if e > _GRID_LIMIT:
        raise ValueError(f"moe_mlp grid too large: {e} experts")
    out = torch.empty_like(buf)
    if out.numel() == 0:
        return out
    moe_mlp_cuda(buf, gate, up, down, out)
    launches += 1
    return out
