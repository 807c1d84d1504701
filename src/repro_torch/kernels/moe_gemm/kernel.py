"""ctypes binding of the CUDA grouped expert MLP (``csrc/moe.cu``).

Replaces ``src/repro/kernels/moe_gemm/kernel.py:moe_mlp_pallas``: stage 1
writes ``h = silu(buf @ gate) * (buf @ up)`` per expert, rounded to the
dtype, to a scratch ``[E, C, f]``; stage 2 computes ``h @ down``.  Three
routes, one entry point each: ``wgmma`` (bf16: a scan for the experts with a
nonzero row, then two persistent TMA + wgmma launches over those experts
alone), ``simple`` (bf16 FMA tiles over every expert) and ``fp32`` (the scan,
then the FMA tiles over the experts with a row).  Bound and design notes are
in the CUDA source.
"""
from __future__ import annotations

import torch

from .._build import library, sm_count, stream_of

_ENTRY = {"wgmma": "moe_mlp_bf16", "simple": "moe_mlp_simple_bf16",
          "fp32": "moe_mlp_f32"}


def moe_mlp_cuda(buf: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                 down: torch.Tensor, out: torch.Tensor, route: str,
                 counts: torch.Tensor | None = None) -> None:
    """Launch ``route`` on the current stream; the wrapper has checked the
    operands.  The scratch (h, and the per-expert flags of the routes that
    skip empty experts) comes from ``torch.empty``, so a launch inside a
    CUDA graph records it from the graph's pool.  ``counts`` (int32 [E] on
    the card, or None) bounds each expert's rows."""
    e, c, d = buf.shape
    f = gate.shape[-1]
    h = torch.empty((e, c, f), dtype=buf.dtype, device=buf.device)
    ptrs = [buf.data_ptr(), gate.data_ptr(), up.data_ptr(), down.data_ptr(),
            h.data_ptr()]
    if route != "simple":
        flags = torch.empty(e, dtype=torch.int32, device=buf.device)
        ptrs.append(flags.data_ptr())
    ptrs.append(0 if counts is None else counts.data_ptr())
    shape = [e, c, d, f]
    if route == "wgmma":
        shape.append(sm_count(buf.device))
    fn = getattr(library(), _ENTRY[route])
    err = fn(*ptrs, out.data_ptr(), *shape, stream_of(buf))
    if err != 0:
        raise RuntimeError(f"moe_gemm {route} launch failed: CUDA error "
                           f"{err}")
