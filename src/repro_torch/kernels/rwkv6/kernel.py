"""ctypes binding of the CUDA WKV6 recurrence (``csrc/rwkv6.cu``).

Replaces ``src/repro/kernels/rwkv6/kernel.py:rwkv6_pallas``: one block per
(batch row, head) walks the T steps with the ``[K, K]`` fp32 state in
registers.  Bound and design notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from .._build import library, stream_of


def rwkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
               out: torch.Tensor, s_final: torch.Tensor) -> None:
    """Launch on the current stream; the wrapper has checked the operands."""
    b, h, t, kd = r.shape
    err = library().rwkv6_f32(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), out.data_ptr(), s_final.data_ptr(), b, h, t, kd,
        stream_of(r))
    if err != 0:
        raise RuntimeError(f"rwkv6 launch failed: CUDA error {err}")
