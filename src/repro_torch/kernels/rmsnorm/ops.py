"""Public wrapper of the fused RMSNorm.

CPU tensors take the plain version (``ref.py``).  CUDA tensors launch the
kernel or raise: any row count and width are taken.  ``launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from .. import use_kernel
from .kernel import _ENTRY, rmsnorm_cuda
from .ref import rmsnorm_ref

launches = 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [..., d] (leading dims flattened for the kernel); scale: [d]."""
    global launches
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} does not match the "
                         f"width {d} of x {tuple(x.shape)}")
    if not use_kernel(x, scale):
        return rmsnorm_ref(x, scale, eps)
    if x.dtype != scale.dtype or x.dtype not in _ENTRY:
        raise TypeError(f"rmsnorm takes bf16 or fp32 operands of one dtype, "
                        f"got x {x.dtype}, scale {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm needs contiguous operands")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rmsnorm_cuda(x.view(-1, d), scale, out.view(-1, d), float(eps))
    launches += 1
    return out
