"""ctypes binding of the CUDA Mamba selective scan (``csrc/mamba_scan.cu``).

Replaces no TPU kernel: the JAX package leaves the scan to XLA.  One entry
point per dtype takes the op graph's scan-stage input ``packed`` (x | z | B
| C | dt_raw) through its batch and time strides and writes ``out`` [B, T,
di]: a block of 16 channels (eight lanes a channel) walks T with the
state in registers.  Bound and design notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from .._build import library, stream_of


def mamba_scan_stage_cuda(packed: torch.Tensor, a_log: torch.Tensor,
                    d_skip: torch.Tensor, out: torch.Tensor) -> None:
    """Launch on the current stream; the wrapper has checked the operands
    (packed [B,T,W] with a unit last stride, a_log [di,N], d_skip [di] fp32
    contiguous, out [B,T,di] contiguous in packed's dtype)."""
    b, t, _ = packed.shape
    di, n = a_log.shape
    lib = library()
    entry = (lib.mamba_scan_bf16 if packed.dtype == torch.bfloat16
             else lib.mamba_scan_f32)
    err = entry(packed.data_ptr(), a_log.data_ptr(), d_skip.data_ptr(),
                out.data_ptr(), b, t, di, n, packed.stride(0),
                packed.stride(1), stream_of(packed))
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
