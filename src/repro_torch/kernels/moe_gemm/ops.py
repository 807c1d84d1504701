"""Public wrapper of the grouped expert SwiGLU MLP.

CPU tensors take the plain version (``ref.py``).  CUDA tensors launch the
kernel or raise: any E, C >= 0, d and f are taken.  With ``counts`` (int32
``[E]`` on the buffers' device, written there by the caller's dispatch)
only the first ``counts[e]`` rows of expert e are read, computed and
written: the expert-parallel layer's dropless buffers hold up to every
token an expert, and its work follows the routed rows.  :func:`route` picks the
kernel's route from dtype, shape and alignment alone; ``launches`` counts
wrapper calls that launched the kernel (its launches count as one) and
``launches_by_route`` splits them by route.
"""
from __future__ import annotations

import torch

from .. import MOE_MAX_EXPERTS, use_kernel
from .kernel import moe_mlp_cuda
from .ref import moe_mlp_ref

ROUTES = ("wgmma", "simple", "fp32")
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)
_GRID_LIMIT = 65535     # blockIdx.y (experts) of the simple and fp32 routes


def route(buf: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
          down: torch.Tensor, counted: bool = False) -> str:
    """The kernel route for ``buf [E,C,d]`` and the expert weights:
    ``"fp32"`` for fp32; for bf16 ``"wgmma"`` when TMA can read every
    operand (d and f multiples of 8, so every row stride is a multiple of 16
    bytes, and 16-byte aligned bases) and the experts fit the route's list
    (E <= MOE_MAX_EXPERTS, a quarter of that under device counts: csrc's
    MAX_COUNTED_EXPERTS), else ``"simple"``."""
    if buf.dtype == torch.float32:
        return "fp32"
    e, _, d = buf.shape
    f = gate.shape[-1]
    most = MOE_MAX_EXPERTS // 4 if counted else MOE_MAX_EXPERTS
    if (d % 8 == 0 and f % 8 == 0 and e <= most
            and all(t.data_ptr() % 16 == 0 for t in (buf, gate, up, down))):
        return "wgmma"
    return "simple"


def _check(buf: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor, counts: torch.Tensor | None = None,
           out: torch.Tensor | None = None) -> None:
    if buf.dim() != 3 or gate.dim() != 3:
        raise ValueError(f"moe_mlp wants buf [E,C,d] and weights [E,d,f], "
                         f"got {tuple(buf.shape)}, {tuple(gate.shape)}")
    e, c, d = buf.shape
    f = gate.shape[-1]
    if (tuple(gate.shape) != (e, d, f) or tuple(up.shape) != (e, d, f)
            or tuple(down.shape) != (e, f, d)):
        raise ValueError(f"moe_mlp shape mismatch: buf {tuple(buf.shape)}, "
                         f"gate {tuple(gate.shape)}, up {tuple(up.shape)}, "
                         f"down {tuple(down.shape)}")
    if counts is not None and (
            tuple(counts.shape) != (e,) or counts.dtype != torch.int32
            or counts.device != buf.device or not counts.is_contiguous()):
        raise ValueError(f"moe_mlp counts must be contiguous int32 [{e}] on "
                         f"{buf.device}, got {tuple(counts.shape)} "
                         f"{counts.dtype} on {counts.device}")
    if out is not None and (
            out.shape != buf.shape or out.dtype != buf.dtype
            or out.device != buf.device or not out.is_contiguous()):
        raise ValueError(f"moe_mlp out must be a contiguous "
                         f"{tuple(buf.shape)} {buf.dtype} on {buf.device}")


def _launch(buf: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
            down: torch.Tensor, path: str, counts: torch.Tensor | None = None,
            out: torch.Tensor | None = None) -> torch.Tensor:
    global launches
    if not (buf.dtype == gate.dtype == up.dtype == down.dtype) \
            or buf.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"moe_mlp takes bf16 or fp32 operands of one dtype, "
                        f"got {buf.dtype}, {gate.dtype}, {up.dtype}, "
                        f"{down.dtype}")
    if not all(t.is_contiguous() for t in (buf, gate, up, down)):
        raise ValueError("moe_mlp needs contiguous operands")
    if buf.shape[0] > _GRID_LIMIT:
        raise ValueError(f"moe_mlp grid too large: {buf.shape[0]} experts")
    out = torch.empty_like(buf) if out is None else out
    if out.numel() == 0:
        return out
    moe_mlp_cuda(buf, gate, up, down, out, path, counts)
    launches += 1
    launches_by_route[path] += 1
    return out


def moe_mlp(buf: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
            down: torch.Tensor, counts: torch.Tensor | None = None,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """buf: [E,C,d]; gate/up: [E,d,f]; down: [E,f,d] → [E,C,d] (``out``
    where given).  With ``counts`` the rows of expert e past ``counts[e]``
    are neither read nor written."""
    _check(buf, gate, up, down, counts, out)
    if not use_kernel(buf, gate, up, down):
        return moe_mlp_ref(buf, gate, up, down, counts, out)
    return _launch(buf, gate, up, down,
                   route(buf, gate, up, down, counts is not None), counts,
                   out)


def moe_mlp_simple_bf16(buf: torch.Tensor, gate: torch.Tensor,
                        up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """The simple route (the first port's FMA tiles over every expert) at
    any bf16 shape on the card, so that a measurement can hold the wgmma
    route against it; counted as a ``simple`` launch."""
    _check(buf, gate, up, down)
    if not use_kernel(buf, gate, up, down):
        raise ValueError("moe_mlp_simple_bf16 needs CUDA tensors")
    if buf.dtype != torch.bfloat16:
        raise TypeError(f"moe_mlp_simple_bf16 takes bf16, got {buf.dtype}")
    return _launch(buf, gate, up, down, "simple")
