"""Public wrappers of the WKV6 recurrence.

CPU tensors take the plain version (``ref.py``) and count nothing.  CUDA
tensors launch the kernel or raise: fp32 operands, any T >= 1 (T = 0
returns the state as it is) and head sizes up to ``RWKV6_MAX_K``.  Both
wrappers read r, k, v, w in place through their strides (the K stride 1):
:func:`rwkv6` takes the kernel layout ``[B,H,T,K]``, :func:`rwkv6_model`
the model layout ``[B,T,H,K]`` and writes its output contiguous in that
layout, so the caller's reshape is a view.  :func:`route` picks the
kernel's route from T, dtype, head size, strides and alignment alone;
``launches`` counts kernel launches (a chunked launch's three kernels count
as one) and ``launches_by_route`` splits them by route.
"""
from __future__ import annotations

import torch

from .. import RWKV6_MAX_K, use_kernel
from .kernel import rwkv6_cuda
from .ref import rwkv6_ref

ROUTES = ("chunked", "step")
# the shortest T the chunked route takes; shorter runs (decode ticks at
# T = 1, short prompts) walk the steps.  On the H100 at B 1, H 32, K 64 the
# two routes measured about even at T = 48, the chunked one ahead from 64
# on (``chip_smoke.py`` times both at 32, 48 and 64; PERF.md §6)
CHUNKED_MIN_T = 48
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)


def _loadable(x: torch.Tensor) -> bool:
    """16-byte loads read ``x``: unit last stride, every other stride a
    whole number of 4 elements, a 16-byte aligned base."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in x.stride()[:-1]))


def route(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor) -> str:
    """The kernel route for r, k, v, w ``[B,H,T,K]`` (views of any layout):
    ``"chunked"`` when T >= ``CHUNKED_MIN_T``, K is a multiple of 4 and
    16-byte loads read all four; else ``"step"``.  Raises for operands that
    are not fp32 (neither route takes them)."""
    if any(x.dtype != torch.float32 for x in (r, k, v, w)):
        raise TypeError("rwkv6 takes fp32 operands")
    t, kd = r.shape[2], r.shape[3]
    if t >= CHUNKED_MIN_T and kd % 4 == 0 and all(
            map(_loadable, (r, k, v, w))):
        return "chunked"
    return "step"


def _check(r, k, v, w, u, s0) -> None:
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv6 wants r, k, v, w of one shape [B,H,T,K], "
                         f"got {[tuple(t.shape) for t in (r, k, v, w)]}")
    b, h, t, kd = r.shape
    if tuple(u.shape) != (h, kd) or tuple(s0.shape) != (b, h, kd, kd):
        raise ValueError(f"rwkv6 wants u [H,K] = {(h, kd)} and s0 [B,H,K,K] "
                         f"= {(b, h, kd, kd)}, got {tuple(u.shape)}, "
                         f"{tuple(s0.shape)}")


def _launch(r, k, v, w, u, s0, out, path: str | None):
    """Launch into ``out`` (a ``[B,H,T,K]`` view the wrapper allocated);
    returns (out, s_final)."""
    global launches
    if any(x.dtype != torch.float32 for x in (r, k, v, w, u, s0)):
        raise TypeError("rwkv6 takes fp32 operands")
    if any(x.stride(-1) != 1 for x in (r, k, v, w)):
        raise ValueError("rwkv6 needs the K dim of r, k, v, w contiguous")
    if not (u.is_contiguous() and s0.is_contiguous()):
        raise ValueError("rwkv6 needs contiguous u and s0")
    b, h, t, kd = r.shape
    if not 0 < kd <= RWKV6_MAX_K:
        raise ValueError(f"rwkv6 takes head sizes up to {RWKV6_MAX_K}, "
                         f"got {kd}")
    s_final = torch.empty_like(s0)
    if b * h == 0 or t == 0:
        return out, s_final.copy_(s0)
    path = path or route(r, k, v, w)
    rwkv6_cuda(r, k, v, w, u, s0, out, s_final, path)
    launches += 1
    launches_by_route[path] += 1
    return out, s_final


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor, s0: torch.Tensor):
    """Kernel layout: r, k, v, w [B,H,T,K] fp32; u [H,K]; s0 [B,H,K,K] →
    (out [B,H,T,K], s_final [B,H,K,K])."""
    _check(r, k, v, w, u, s0)
    if not use_kernel(r, k, v, w, u, s0):
        return rwkv6_ref(r, k, v, w, u, s0)
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    return _launch(r, k, v, w, u, s0, out, None)


def rwkv6_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """The step route (the first port's routine) at any T on the card, so
    that a measurement can hold the chunked route against it; counted as a
    ``step`` launch."""
    _check(r, k, v, w, u, s0)
    if not use_kernel(r, k, v, w, u, s0):
        raise ValueError("rwkv6_step needs CUDA tensors")
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    return _launch(r, k, v, w, u, s0, out, "step")


def rwkv6_model(rh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                wh: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """Model layout: rh, kh, vh, wh [B,T,H,K] → (y [B,T,H,K] contiguous,
    s_final [B,H,K,K]).  The kernel reads the four in place (transposed
    views) and writes y in this layout."""
    args = [x.transpose(1, 2).float() for x in (rh, kh, vh, wh)]
    _check(*args, u, s0)
    if not use_kernel(*args, u, s0):
        out, s_final = rwkv6_ref(*args, u, s0)
        return out.transpose(1, 2).contiguous(), s_final
    out = torch.empty(rh.shape, dtype=torch.float32, device=rh.device)
    _, s_final = _launch(*args, u.contiguous(), s0.contiguous(),
                         out.transpose(1, 2), None)
    return out, s_final
