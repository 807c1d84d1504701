"""Public wrappers of the grouped ragged-M GEMM.

:func:`tile_table` builds the kernel's ``(group, row_start, row_end)`` table
for static group sizes; the capturer builds it ONCE when it lowers a
grouped step, so replay does no host→device copy.  :func:`grouped_gemm` is
the flat form over rows concatenated per group, :func:`grouped_gemm_parts`
the per-branch form the capturer calls.  CPU tensors take the plain version;
CUDA tensors launch the kernel or raise, on the route that branch_gemm's
:func:`~repro_torch.kernels.branch_gemm.ops.route` picks.  ``launches``
counts launches, ``launches_by_route`` splits them by route.
"""
from __future__ import annotations

import torch

from .. import TILE_M, use_kernel
from ..branch_gemm.ops import (ROUTES, check_cuda_operands, route,
                               select_tiles)
from .kernel import GROUPED_TILES, grouped_gemm_cuda
from .ref import grouped_gemm_ref

launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)
_GRID_LIMIT = 65535     # blockIdx.y (row tiles) of the simple and fp32 routes
_BLOCKS_LIMIT = 2**31 - 1   # blockIdx.x of the wgmma route


def tile_rows(group_sizes: tuple[int, ...]) -> list[tuple[int, int, int]]:
    """``(group, row_start, row_end)`` per row tile of ``TILE_M`` rows; a
    zero-row group contributes no tile."""
    rows, off = [], 0
    for g, m in enumerate(group_sizes):
        for start in range(off, off + m, TILE_M):
            rows.append((g, start, off + m))
        off += m
    return rows


def tile_table(group_sizes: tuple[int, ...],
               device: torch.device | str) -> torch.Tensor:
    """The kernel's tile table as an int32 ``[T, 3]`` tensor on ``device``."""
    rows = tile_rows(group_sizes)
    return torch.tensor(rows, dtype=torch.int32,
                        device=device).reshape(len(rows), 3)


def _check_sizes(x: torch.Tensor, w: torch.Tensor,
                 group_sizes: tuple[int, ...]) -> None:
    if w.dim() != 3:
        raise ValueError(f"w must be [N, K, F], got {tuple(w.shape)}")
    n, k, _ = w.shape
    if len(group_sizes) != n:
        raise ValueError(f"{len(group_sizes)} group sizes for {n} groups")
    if any(m < 0 for m in group_sizes):
        raise ValueError(f"negative group size in {group_sizes}")
    total = sum(group_sizes)
    if tuple(x.shape) != (total, k):
        raise ValueError(f"x {tuple(x.shape)} != (sum_M={total}, K={k})")


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 group_sizes: tuple[int, ...],
                 table: torch.Tensor | None = None) -> torch.Tensor:
    """Flat form: rows ``[sum_M, K]`` (group ``i`` owns the
    ``group_sizes[i]`` rows after groups ``< i``) → ``[sum_M, F]``.
    ``table`` is :func:`tile_table` of ``group_sizes`` on x's device; it is
    built here when not given (a host→device copy: pass it from code that
    runs under CUDA-graph capture)."""
    group_sizes = tuple(int(m) for m in group_sizes)
    _check_sizes(x, w, group_sizes)
    if not use_kernel(x, w):
        return grouped_gemm_ref(x, w, group_sizes)
    check_cuda_operands("grouped_gemm", x, w,
                        (torch.bfloat16, torch.float32))
    return _launch(x, w, group_sizes, table, route(x, w))


def grouped_gemm_simple_bf16(x: torch.Tensor, w: torch.Tensor,
                             group_sizes: tuple[int, ...],
                             table: torch.Tensor | None = None,
                             ) -> torch.Tensor:
    """The simple route (WMMA on 64x64 tiles) at any bf16 shape on the card,
    so that a measurement can hold the wgmma route against it; counted as a
    ``simple`` launch."""
    group_sizes = tuple(int(m) for m in group_sizes)
    _check_sizes(x, w, group_sizes)
    if not use_kernel(x, w):
        raise ValueError("grouped_gemm_simple_bf16 needs CUDA tensors")
    check_cuda_operands("grouped_gemm", x, w, (torch.bfloat16,))
    return _launch(x, w, group_sizes, table, "simple")


def _launch(x: torch.Tensor, w: torch.Tensor, group_sizes: tuple[int, ...],
            table: torch.Tensor | None, path: str) -> torch.Tensor:
    global launches
    if table is None:
        table = tile_table(group_sizes, x.device)
    n_tiles = len(tile_rows(group_sizes))
    if (table.dtype != torch.int32 or table.device != x.device
            or tuple(table.shape) != (n_tiles, 3)
            or not table.is_contiguous()):
        raise ValueError(f"tile table must be int32 [{n_tiles}, 3] on "
                         f"{x.device}, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}")
    k, f = w.shape[1], w.shape[2]
    bn = None
    if path == "wgmma":
        bn = select_tiles(1, n_tiles * TILE_M, k, f, GROUPED_TILES)[1]
        fits = n_tiles * -(-f // bn) <= _BLOCKS_LIMIT
    else:
        fits = n_tiles <= _GRID_LIMIT
    if not fits:
        raise ValueError(f"grouped_gemm grid too large: {n_tiles} row tiles")
    out = torch.empty((x.shape[0], f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    grouped_gemm_cuda(x, w, table, out, path, bn)
    launches += 1
    launches_by_route[path] += 1
    return out


def grouped_gemm_parts(xs: list[torch.Tensor], w: torch.Tensor,
                       table: torch.Tensor | None = None,
                       ) -> list[torch.Tensor]:
    """Ragged fused GEMM over per-branch parts: ``xs[i]: [M_i, K]`` against
    ``w: [N, K, F]`` → one ``[M_i, F]`` output per branch (views into one
    output).  Zero-row parts are allowed."""
    sizes = tuple(int(x.shape[0]) for x in xs)
    out = grouped_gemm(torch.cat(list(xs), dim=0), w, sizes, table)
    return list(torch.split(out, sizes, dim=0))
