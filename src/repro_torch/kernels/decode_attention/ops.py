"""Public wrapper of the dense-slab decode attention kernel.

Takes the cache layout ``k, v [B,T,KVH,D]`` (read in place) and a boolean
``valid [B,T]``.  CPU tensors take the plain version (``ref.py``).  CUDA
tensors launch the kernel or raise: any T and any D up to 128 are taken,
with at most 16 query heads per KV head.  ``launches`` counts kernel
launches (the split pass and its combine count as one).  A row with no
attended position gives what the plain version and the JAX package give:
the softmax of its all-masked logits is uniform, so the output is V averaged
over all T slab positions (each weight ``1/T`` rounded to V's dtype).  The
model never asks for one, since a sequence always attends its own position.
"""
from __future__ import annotations

import torch

from .. import use_kernel
from .kernel import _ENTRY, decode_attention_cuda
from .ref import decode_attention_ref

launches = 0
MAX_D = 128             # csrc MAX_D
MAX_GROUP = 16          # query heads per KV head (csrc MAX_GROUP)
_GRID_LIMIT = 65535     # blockIdx.y (KV heads) and blockIdx.z (batch)


def check_decode_operands(name: str, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> None:
    """What both decode kernels need of q [B,H,Dk] and K/V [..,KVH,D]."""
    h, dk = q.shape[1], q.shape[2]
    kvh, dv = k.shape[2], v.shape[-1]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"{name} takes bf16 or fp32 operands of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if dk > MAX_D or dv > MAX_D or h // kvh > MAX_GROUP:
        raise ValueError(f"{name} takes head dims up to {MAX_D} and up to "
                         f"{MAX_GROUP} query heads per KV head, got Dk={dk}, "
                         f"Dv={dv}, H/KVH={h // kvh}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name} needs the head dim contiguous")
    if kvh > _GRID_LIMIT or q.shape[0] > _GRID_LIMIT:
        raise ValueError(f"{name} grid too large for B={q.shape[0]}, "
                         f"KVH={kvh}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """One query token per sequence against the cache: q [B,H,D];
    k, v [B,T,KVH,D]; valid [B,T] bool (True = attended) → [B,H,D]."""
    global launches
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention wants q [B,H,D], k = v "
                         f"[B,T,KVH,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kvh == 0 or h % kvh:
        raise ValueError(f"decode_attention shape mismatch q "
                         f"{tuple(q.shape)} vs cache {tuple(k.shape)}")
    if tuple(valid.shape) != (b, t):
        raise ValueError(f"valid {tuple(valid.shape)} != (B={b}, T={t})")
    if not use_kernel(q, k, v, valid):
        return decode_attention_ref(q, k, v, valid)
    check_decode_operands("decode_attention", q, k, v)
    if valid.dtype != torch.bool or valid.stride(-1) != 1:
        raise TypeError(f"decode_attention takes a bool valid mask with "
                        f"contiguous rows, got {valid.dtype} strides "
                        f"{valid.stride()}")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or t == 0:
        return out.zero_()
    decode_attention_cuda(q, k, v, valid, out)
    launches += 1
    return out
