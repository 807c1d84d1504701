"""Public wrapper of the flash attention prefill kernel.

Takes the model layout ``q [B,S,H,D]``, ``k, v [B,T,KVH,D]`` (the kernel
reads it through strides, so no transpose is made).  CPU tensors take the
plain version (``ref.py``).  CUDA tensors launch the kernel or raise: any S
and T and any D up to 128 are taken (edges are masked in the kernel), and
the window is a runtime argument.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import use_kernel
from .kernel import _ENTRY, flash_attention_cuda
from .ref import flash_attention_ref

launches = 0
MAX_D = 128             # the kernel's largest head dim (csrc MAX_D)
_GRID_LIMIT = 65535     # blockIdx.y (heads) and blockIdx.z (batch)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal (and, with ``window > 0``, sliding-window) GQA attention:
    q [B,S,H,D]; k, v [B,T,KVH,D] → [B,S,H,D]; scale D^-½."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q [B,S,H,D], k = v "
                         f"[B,T,KVH,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention shape mismatch q {tuple(q.shape)}"
                         f" vs k {tuple(k.shape)}")
    window = int(window)
    if not use_kernel(q, k, v):
        return flash_attention_ref(q, k, v, causal, window)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes bf16 or fp32 operands of one"
                        f" dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > MAX_D:
        raise ValueError(f"flash_attention takes head dims up to {MAX_D}, "
                         f"got {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs the head dim contiguous")
    if h > _GRID_LIMIT or b > _GRID_LIMIT:
        raise ValueError(f"flash_attention grid too large for B={b}, H={h}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0 or k.shape[1] == 0:
        return out.zero_()
    flash_attention_cuda(q, k, v, out, causal, window, d ** -0.5)
    launches += 1
    return out
