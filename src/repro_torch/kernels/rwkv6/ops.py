"""Public wrappers of the WKV6 recurrence.

CPU tensors take the plain version (``ref.py``).  CUDA tensors launch the
kernel or raise: fp32 operands, any T >= 1 (T = 0 returns the state as it
is) and head sizes up to ``RWKV6_MAX_K``.  ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from .. import RWKV6_MAX_K, use_kernel
from .kernel import rwkv6_cuda
from .ref import rwkv6_ref

launches = 0


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor, s0: torch.Tensor):
    """Kernel layout: r, k, v, w [B,H,T,K] fp32; u [H,K]; s0 [B,H,K,K] →
    (out [B,H,T,K], s_final [B,H,K,K])."""
    global launches
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv6 wants r, k, v, w of one shape [B,H,T,K], "
                         f"got {[tuple(t.shape) for t in (r, k, v, w)]}")
    b, h, t, kd = r.shape
    if tuple(u.shape) != (h, kd) or tuple(s0.shape) != (b, h, kd, kd):
        raise ValueError(f"rwkv6 wants u [H,K] = {(h, kd)} and s0 [B,H,K,K] "
                         f"= {(b, h, kd, kd)}, got {tuple(u.shape)}, "
                         f"{tuple(s0.shape)}")
    if not use_kernel(r, k, v, w, u, s0):
        return rwkv6_ref(r, k, v, w, u, s0)
    if any(x.dtype != torch.float32 for x in (r, k, v, w, u, s0)):
        raise TypeError("rwkv6 takes fp32 operands")
    if not all(x.is_contiguous() for x in (r, k, v, w, u, s0)):
        raise ValueError("rwkv6 needs contiguous operands")
    if not 0 < kd <= RWKV6_MAX_K:
        raise ValueError(f"rwkv6 takes head sizes up to {RWKV6_MAX_K}, "
                         f"got {kd}")
    out = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    if b * h == 0 or t == 0:
        return out, s_final.copy_(s0)
    rwkv6_cuda(r, k, v, w, u, s0, out, s_final)
    launches += 1
    return out, s_final


def rwkv6_model(rh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                wh: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """Model layout: rh, kh, vh, wh [B,T,H,K] → (y [B,T,H,K], s_final
    [B,H,K,K]), through the kernel layout (one transpose copy each way)."""
    args = [x.transpose(1, 2).float().contiguous() for x in (rh, kh, vh, wh)]
    out, s_final = rwkv6(*args, u.contiguous(), s0.contiguous())
    return out.transpose(1, 2), s_final
