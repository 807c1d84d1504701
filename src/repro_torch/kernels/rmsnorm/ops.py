"""Public wrapper of the fused RMSNorm.

CPU tensors take the plain version (``ref.py``).  CUDA tensors launch the
kernel or raise: any row count and width are taken.  :func:`route` picks the
kernel's route from dtype, width and alignment alone; ``launches`` counts
kernel launches and ``launches_by_route`` splits them by route.
"""
from __future__ import annotations

import torch

from .. import use_kernel
from .kernel import DTYPES, max_vectors, rmsnorm_cuda
from .ref import rmsnorm_ref

ROUTES = ("onepass", "simple")
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)


def route(x: torch.Tensor, scale: torch.Tensor) -> str:
    """``"onepass"`` when the row is a whole number of 16-byte vectors, at
    most :func:`~.kernel.max_vectors` of them, and both bases are 16-byte
    aligned (a view may start anywhere); else ``"simple"``."""
    width = x.shape[-1] * x.element_size()
    if (width % 16 == 0 and 0 < width // 16 <= max_vectors()
            and x.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0):
        return "onepass"
    return "simple"


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} does not match the "
                         f"width {d} of x {tuple(x.shape)}")


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float,
            path: str) -> torch.Tensor:
    global launches
    if x.dtype != scale.dtype or x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm takes bf16 or fp32 operands of one dtype, "
                        f"got x {x.dtype}, scale {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm needs contiguous operands")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    d = x.shape[-1]
    rmsnorm_cuda(x.view(-1, d), scale, out.view(-1, d), float(eps), path)
    launches += 1
    launches_by_route[path] += 1
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [..., d] (leading dims flattened for the kernel); scale: [d]."""
    _check(x, scale)
    if not use_kernel(x, scale):
        return rmsnorm_ref(x, scale, eps)
    return _launch(x, scale, eps, route(x, scale))


def rmsnorm_simple(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """The simple route (the first port's two-pass routine) at any shape on
    the card, so that a measurement can hold the onepass route against it;
    counted as a ``simple`` launch."""
    _check(x, scale)
    if not use_kernel(x, scale):
        raise ValueError("rmsnorm_simple needs CUDA tensors")
    return _launch(x, scale, eps, "simple")
