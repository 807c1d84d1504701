"""Public wrapper of the op graph's Mamba scan stage.

CPU tensors take the plain version (``ref.py``) and count nothing.  CUDA
tensors launch the kernel or raise: ``packed`` bf16 or fp32 with its last
dim contiguous (batch and time strides free, so a view of a wider tensor is
read in place), ``a_log`` and ``d_skip`` fp32 and contiguous, any T >= 1,
at most ``MAMBA_SCAN_MAX_STATE`` states and 65535 batch rows.  ``launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import MAMBA_SCAN_MAX_STATE, use_kernel
from .kernel import mamba_scan_stage_cuda
from .ref import mamba_scan_stage_ref

launches = 0


def _check(packed: torch.Tensor, a_log: torch.Tensor,
           d_skip: torch.Tensor) -> None:
    if packed.dim() != 3 or a_log.dim() != 2 or d_skip.dim() != 1:
        raise ValueError(f"mamba_scan wants packed [B,T,W], a_log [di,N] and "
                         f"d_skip [di], got {tuple(packed.shape)}, "
                         f"{tuple(a_log.shape)}, {tuple(d_skip.shape)}")
    di, n = a_log.shape
    if d_skip.shape[0] != di or packed.shape[-1] != 2 * di + 2 * n + 1:
        raise ValueError(f"mamba_scan wants packed's last dim 2·di+2·N+1 = "
                         f"{2 * di + 2 * n + 1} and d_skip [{di}], got "
                         f"{packed.shape[-1]} and {tuple(d_skip.shape)}")
    if packed.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"mamba_scan takes bf16 or fp32 packed, got "
                        f"{packed.dtype}")
    if a_log.dtype != torch.float32 or d_skip.dtype != torch.float32:
        raise TypeError(f"mamba_scan takes fp32 a_log and d_skip, got "
                        f"{a_log.dtype}, {d_skip.dtype}")


def mamba_scan_stage(packed: torch.Tensor, a_log: torch.Tensor,
               d_skip: torch.Tensor) -> torch.Tensor:
    """packed [B,T,2·di+2·N+1] (x ‖ z ‖ B ‖ C ‖ Δ_raw) in bf16 or fp32,
    a_log [di,N] and d_skip [di] fp32 → out [B,T,di] in packed's dtype:
    the selective scan from the zero state, the D skip and the silu(z)
    gate."""
    global launches
    _check(packed, a_log, d_skip)
    if not use_kernel(packed, a_log, d_skip):
        return mamba_scan_stage_ref(packed, a_log, d_skip)
    if packed.stride(-1) != 1:
        raise ValueError("mamba_scan needs packed's last dim contiguous")
    if not (a_log.is_contiguous() and d_skip.is_contiguous()):
        raise ValueError("mamba_scan needs contiguous a_log and d_skip")
    b, t, _ = packed.shape
    di, n = a_log.shape
    if not 0 < n <= MAMBA_SCAN_MAX_STATE:
        raise ValueError(f"mamba_scan takes 1 to {MAMBA_SCAN_MAX_STATE} "
                         f"states, got {n}")
    if b > 65535:
        raise ValueError(f"mamba_scan takes at most 65535 batch rows, got {b}")
    out = torch.empty((b, t, di), dtype=packed.dtype, device=packed.device)
    if out.numel() == 0:
        return out
    mamba_scan_stage_cuda(packed, a_log, d_skip, out)
    launches += 1
    return out
