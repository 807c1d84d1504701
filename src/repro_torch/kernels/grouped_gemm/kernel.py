"""ctypes binding of the CUDA grouped ragged-M GEMM (``csrc/gemm.cu``).

Replaces ``src/repro/kernels/grouped_gemm/kernel.py:grouped_gemm_pallas``:
rows of N groups concatenated WITHOUT padding, ``x [sum M, K]`` against
``w [N, K, F]`` → ``[sum M, F]``.  Each row tile of ``TILE_M`` rows reads
``(group, row_start, row_end)`` from a device int32 table and drops the
rows past its group's end, which replaces the reference's per-group
zero-padding copy.  The routes are branch_gemm's (``wgmma``, ``simple``,
``fp32``).  Bound and design notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from .. import TILE_M
from .._build import library, stream_of

# (BM, BN) instantiations of the wgmma route; BM is the table's TILE_M
GROUPED_TILES = ((TILE_M, 256), (TILE_M, 128))

_ENTRY = {"wgmma": "grouped_gemm_bf16", "simple": "grouped_gemm_simple_bf16",
          "fp32": "grouped_gemm_f32"}


def grouped_gemm_cuda(x: torch.Tensor, w: torch.Tensor, table: torch.Tensor,
                      out: torch.Tensor, route: str,
                      bn: int | None = None) -> None:
    """Launch ``route`` on the current stream (``bn`` for wgmma); the
    wrapper has checked the operands."""
    n, k, f = w.shape
    fn = getattr(library(), _ENTRY[route])
    if route == "wgmma":
        args = (table.shape[0], x.shape[0], n, k, f, bn)
    else:
        args = (table.shape[0], k, f)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), table.data_ptr(),
             *args, stream_of(x))
    if err != 0:
        raise RuntimeError(f"grouped_gemm {route} launch failed: CUDA error "
                           f"{err}")
