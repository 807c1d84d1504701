"""ctypes bindings of the CUDA WKV6 recurrence (``csrc/rwkv6.cu``).

Replaces ``src/repro/kernels/rwkv6/kernel.py:rwkv6_pallas``.  Two routes,
one entry point each, both reading r, k, v, w and writing out through their
element strides (the kernel layout ``[B,H,T,K]`` or a transposed view of the
model layout ``[B,T,H,K]``): ``step`` (one block per (batch row, head) walks
the T steps with the ``[K, K]`` fp32 state in registers) and ``chunked``
(chunks of ``RWKV6_CHUNK`` positions in parallel: each chunk's state
contribution, a carry of the state over the chunks, each chunk's outputs,
three kernels of one launch; products of decays only, fp32 FMA).  Bound and design notes are in the CUDA
source.
"""
from __future__ import annotations

import torch

from .. import RWKV6_CHUNK, RWKV6_MAX_K
from .._build import library, stream_of, strides

def _strides(*xs: torch.Tensor):
    """(batch, head, time) element strides of each [B,H,T,K] operand."""
    return strides(*(s for x in xs for s in x.stride()[:3]))


def scratch(b: int, h: int, t: int, device: torch.device) -> torch.Tensor:
    """The chunked route's fp32 scratch: per (row, head, chunk) a
    ``[64, 64]`` state and a ``[64]`` decay (``torch.empty``, so a launch
    inside a CUDA graph takes it from the graph's pool)."""
    n_chunks = -(-t // RWKV6_CHUNK)
    return torch.empty(b * h * n_chunks * (RWKV6_MAX_K + 1) * RWKV6_MAX_K,
                       dtype=torch.float32, device=device)


def rwkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
               out: torch.Tensor, s_final: torch.Tensor, route: str) -> None:
    """Launch ``route`` on the current stream; the wrapper has checked the
    operands (r, k, v, w, out [B,H,T,K] views with unit K stride; u, s0,
    s_final contiguous)."""
    b, h, t, kd = r.shape
    st = _strides(r, k, v, w, out)
    ptrs = [x.data_ptr() for x in (r, k, v, w, u, s0, out, s_final)]
    lib = library()
    if route == "chunked":
        buf = scratch(b, h, t, r.device)
        err = lib.rwkv6_chunked_f32(*ptrs, buf.data_ptr(), b, h, t, kd, st,
                                    stream_of(r))
    else:
        err = lib.rwkv6_f32(*ptrs, b, h, t, kd, st, stream_of(r))
    if err != 0:
        raise RuntimeError(f"rwkv6 {route} launch failed: CUDA error {err}")
