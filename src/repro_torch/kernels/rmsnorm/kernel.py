"""ctypes binding of the CUDA RMSNorm (``csrc/norm.cu``).

Replaces ``src/repro/kernels/rmsnorm/kernel.py:rmsnorm_pallas``: fp32 sum of
squares per row of ``x [N, d]``, output in the input dtype.  Two routes, one
entry point each per dtype: ``onepass`` (the row in registers, a team of
threads a row, laid out by :func:`select_layout`) and ``simple`` (one warp a
row, two passes).  Bound and design notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from .._build import library, sm_count, stream_of

_ENTRY = {("onepass", torch.bfloat16): "rmsnorm_bf16",
          ("onepass", torch.float32): "rmsnorm_f32",
          ("simple", torch.bfloat16): "rmsnorm_simple_bf16",
          ("simple", torch.float32): "rmsnorm_simple_f32"}
DTYPES = (torch.bfloat16, torch.float32)

MAX_TPR = 512           # threads a row, at most (csrc MAX_TPR)
MAX_VPT = 4             # 16-byte vectors a thread holds, at most


def max_vectors() -> int:
    """The widest row the onepass route holds, in 16-byte vectors."""
    return MAX_TPR * MAX_VPT


def select_layout(nvec: int) -> tuple[int, int]:
    """(threads a row, vectors a thread) of the onepass route for rows of
    ``nvec`` 16-byte vectors: the narrowest team of 32 .. 512 threads (a
    power of two) whose registers hold the row at <= 4 vectors a thread.
    On the H100 it was the fastest layout, or as fast as the fastest, at
    every serving width, 512 and 8 rows (wider teams, which spread a few
    rows over more SMs, were slower: a launch this small is latency)."""
    if not 0 < nvec <= max_vectors():
        raise ValueError(f"a row of {nvec} vectors does not fit the "
                         f"onepass route")
    tpr = 32
    while tpr * MAX_VPT < nvec:
        tpr *= 2
    return tpr, -(-nvec // tpr)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
                 eps: float, route: str) -> None:
    """Launch ``route`` on the current stream; the wrapper has checked the
    operands."""
    n, d = x.shape
    fn = getattr(library(), _ENTRY[(route, x.dtype)])
    args = [x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d, eps]
    if route == "onepass":
        args += [*select_layout(d * x.element_size() // 16),
                 sm_count(x.device)]
    err = fn(*args, stream_of(x))
    if err != 0:
        raise RuntimeError(f"rmsnorm {route} launch failed: CUDA error {err}")
