"""Public wrapper of the flash attention prefill kernel.

Takes the model layout ``q [B,S,H,D]``, ``k, v [B,T,KVH,D]`` (the kernel
reads it through strides, so no transpose is made).  CPU tensors take the
plain version (``ref.py``).  CUDA tensors launch the kernel or raise: any S
and T and any D up to 128 are taken (edges are masked in the kernel), and
the window is a runtime argument.  :func:`route` picks the kernel's route
from dtype, head dim, strides and alignment alone; ``launches`` counts
kernel launches and ``launches_by_route`` splits them by route.
"""
from __future__ import annotations

import torch

from .. import use_kernel
from .kernel import flash_attention_cuda
from .ref import flash_attention_ref

ROUTES = ("wgmma", "simple", "fp32")
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)
MAX_D = 128             # the kernel's largest head dim (csrc MAX_D)
_GRID_LIMIT = 65535     # blockIdx.y and blockIdx.z
_BQ = 64                # query rows of a block (every route)


def _tma_readable(t: torch.Tensor) -> bool:
    """TMA reads ``t [B, rows, heads, D]``: the D stride 1, every other
    stride a multiple of 16 bytes, the base 16-byte aligned."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3]))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel route for ``q [B,S,H,D]``, ``k, v [B,T,KVH,D]``:
    ``"fp32"`` for fp32; for bf16 ``"wgmma"`` when D is a multiple of 16 up
    to :data:`MAX_D` and TMA can read all three operands (a view may start
    anywhere and have any strides), else ``"simple"``."""
    if q.dtype == torch.float32:
        return "fp32"
    d = q.shape[-1]
    if 0 < d <= MAX_D and d % 16 == 0 and all(map(_tma_readable, (q, k, v))):
        return "wgmma"
    return "simple"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q [B,S,H,D], k = v "
                         f"[B,T,KVH,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention shape mismatch q {tuple(q.shape)}"
                         f" vs k {tuple(k.shape)}")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                dtypes: tuple[torch.dtype, ...]) -> None:
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in dtypes:
        names = " or ".join("bf16" if t == torch.bfloat16 else "fp32"
                            for t in dtypes)
        raise TypeError(f"flash_attention takes {names} operands of one"
                        f" dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, d = q.shape
    if d > MAX_D:
        raise ValueError(f"flash_attention takes head dims up to {MAX_D}, "
                         f"got {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs the head dim contiguous")
    if b > _GRID_LIMIT or -(-s // _BQ) > _GRID_LIMIT or h > _GRID_LIMIT:
        raise ValueError(f"flash_attention grid too large for B={b}, S={s}, "
                         f"H={h}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, path: str) -> torch.Tensor:
    global launches
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0 or k.shape[1] == 0:
        return out.zero_()
    flash_attention_cuda(q, k, v, out, causal, window, q.shape[-1] ** -0.5,
                         path)
    launches += 1
    launches_by_route[path] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal (and, with ``window > 0``, sliding-window) GQA attention:
    q [B,S,H,D]; k, v [B,T,KVH,D] → [B,S,H,D]; scale D^-½."""
    _check(q, k, v)
    window = int(window)
    if not use_kernel(q, k, v):
        return flash_attention_ref(q, k, v, causal, window)
    _check_cuda(q, k, v, (torch.bfloat16, torch.float32))
    return _launch(q, k, v, causal, window, route(q, k, v))


def flash_attention_simple_bf16(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool = True,
                                window: int = 0) -> torch.Tensor:
    """The simple route (WMMA, S, P and O in shared memory) at any bf16
    shape on the card, so that a measurement can hold the wgmma route
    against it; counted as a ``simple`` launch."""
    _check(q, k, v)
    if not use_kernel(q, k, v):
        raise ValueError("flash_attention_simple_bf16 needs CUDA tensors")
    _check_cuda(q, k, v, (torch.bfloat16,))
    return _launch(q, k, v, causal, int(window), "simple")
