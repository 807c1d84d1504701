"""Public wrapper of the fused branch GEMM.

CPU tensors take the plain version (``ref.py``).  CUDA tensors launch the
kernel or raise.  :func:`route` picks the kernel's route from dtype, shape
and alignment alone, and :func:`select_tiles` the wgmma route's tile;
``launches`` counts kernel launches and ``launches_by_route`` splits them by
route — the counts a run reads to show that its path went through the
kernel, and through which route.
"""
from __future__ import annotations

import torch

from .. import use_kernel
from .kernel import WGMMA_TILES, branch_gemm_cuda
from .ref import branch_gemm_ref

ROUTES = ("wgmma", "simple", "fp32")
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)
_GRID_LIMIT = 65535     # blockIdx.y and blockIdx.z
_SMS = 132              # streaming multiprocessors of an H100 SXM
_BLOCKS_PER_SM = {128: 1, 64: 2}   # csrc/gemm.cu Cfg::MIN_BLOCKS by BM
# Relative tensor-core rate of a BN-wide wgmma (a wider one reads fewer
# shared-memory bytes per product); a guess that only ranks the tiles.
_BN_RATE = {256: 1.0, 128: 0.85, 64: 0.6}
_FILL_TILES = 2         # pipeline fill and epilogue, in K tiles of 64


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel route for operands ``x [..., K]`` and ``w [..., K, F]``:
    ``"fp32"`` for fp32; for bf16 ``"wgmma"`` when TMA can read both (K and
    F multiples of 8, so every row stride is a multiple of 16 bytes, K > 0,
    and 16-byte aligned bases — a view may start anywhere), else
    ``"simple"``."""
    if x.dtype == torch.float32:
        return "fp32"
    k, f = w.shape[-2], w.shape[-1]
    if (k > 0 and k % 8 == 0 and f % 8 == 0 and x.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0):
        return "wgmma"
    return "simple"


def select_tiles(n: int, m: int, k: int, f: int,
                 tiles: tuple[tuple[int, int], ...] = WGMMA_TILES,
                 ) -> tuple[int, int]:
    """The (BM, BN) of ``tiles`` that finishes ``n`` GEMMs of [m, k] @ [k, f]
    soonest by a wave model: blocks fill 132 SMs (two BM-64 blocks an SM),
    a wave takes its SM's tile area over the BN's rate for the K tiles plus
    the pipeline's fill.  Narrow shapes thus take small tiles and enough
    blocks to fill the card; ties go to the earlier (larger) tile."""
    def cost(tile: tuple[int, int]) -> float:
        bm, bn = tile
        per_sm = _BLOCKS_PER_SM[bm]
        blocks = n * -(-m // bm) * -(-f // bn)
        waves = -(-blocks // (_SMS * per_sm))
        return (waves * bm * per_sm * bn / _BN_RATE[bn]
                * (-(-k // 64) + _FILL_TILES))
    return min(tiles, key=cost)


def _grid_fits(path: str, n: int, m: int, f: int,
               tiles: tuple[int, int] | None) -> bool:
    if path == "wgmma":
        return n <= _GRID_LIMIT and -(-f // tiles[1]) <= _GRID_LIMIT
    return n <= _GRID_LIMIT and -(-m // 64) <= _GRID_LIMIT


def _launch(x: torch.Tensor, w: torch.Tensor, path: str) -> torch.Tensor:
    global launches
    n, m, k = x.shape
    f = w.shape[2]
    tiles = select_tiles(n, m, k, f) if path == "wgmma" else None
    if not _grid_fits(path, n, m, f, tiles):
        raise ValueError(f"branch_gemm grid too large for N={n}, M={m}, F={f}")
    out = torch.empty((n, m, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    branch_gemm_cuda(x, w, out, path, tiles)
    launches += 1
    launches_by_route[path] += 1
    return out


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"branch_gemm wants [N,M,K] @ [N,K,F], got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    n, _, k = x.shape
    if w.shape[0] != n or w.shape[1] != k:
        raise ValueError(f"shape mismatch {tuple(x.shape)} @ {tuple(w.shape)}")


def check_cuda_operands(kernel: str, x: torch.Tensor, w: torch.Tensor,
                        dtypes: tuple[torch.dtype, ...]) -> None:
    """What every route takes: one dtype of ``dtypes``, contiguous."""
    if x.dtype != w.dtype or x.dtype not in dtypes:
        names = " or ".join("bf16" if d == torch.bfloat16 else "fp32"
                            for d in dtypes)
        raise TypeError(f"{kernel} takes {names} operands of one dtype, "
                        f"got {x.dtype} @ {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{kernel} needs contiguous operands")


def branch_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused N-branch GEMM: [N,M,K] @ [N,K,F] → [N,M,F]."""
    _check(x, w)
    if not use_kernel(x, w):
        return branch_gemm_ref(x, w)
    check_cuda_operands("branch_gemm", x, w, (torch.bfloat16, torch.float32))
    return _launch(x, w, route(x, w))


def branch_gemm_simple_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The simple route (WMMA on 64x64 tiles) at any bf16 shape on the card,
    so that a measurement can hold the wgmma route against it; counted as a
    ``simple`` launch."""
    _check(x, w)
    if not use_kernel(x, w):
        raise ValueError("branch_gemm_simple_bf16 needs CUDA tensors")
    check_cuda_operands("branch_gemm", x, w, (torch.bfloat16,))
    return _launch(x, w, "simple")
