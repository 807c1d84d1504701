"""Public wrapper of the dense-slab decode attention kernel.

Takes the cache layout ``k, v [B,T,KVH,D]`` (read in place) and a boolean
``valid [B,T]``.  CPU tensors take the plain version (``ref.py``).  CUDA
tensors launch the kernel or raise: any T and any D up to 128 are taken,
with at most 16 query heads per KV head.  :func:`route` picks the kernel's
route from dtype, head dims, strides and alignment alone, and
``paged_decode`` routes by the same rule.  ``launches`` counts kernel
launches (the split pass and its combine count as one) and
``launches_by_route`` splits them by route.  A row with no attended
position gives what the plain version and the JAX package give: the softmax
of its all-masked logits is uniform, so the output is V averaged over all T
slab positions (each weight ``1/T`` rounded to V's dtype).  The model never
asks for one, since a sequence always attends its own position.
"""
from __future__ import annotations

import torch

from .. import use_kernel
from .kernel import decode_attention_cuda
from .ref import decode_attention_ref

ROUTES = ("mma", "simple", "fp32")
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)
MAX_D = 128             # csrc MAX_D
MAX_GROUP = 16          # query heads per KV head (csrc MAX_GROUP)
_GRID_LIMIT = 65535     # blockIdx.y (KV heads) and blockIdx.z (batch)
DTYPES = (torch.bfloat16, torch.float32)


def copyable(t: torch.Tensor) -> bool:
    """16-byte copies read ``t``: the last stride 1, every other stride a
    multiple of 16 bytes, the base 16-byte aligned."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * t.element_size() % 16 == 0 for s in t.stride()[:-1]))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel route for ``q [B,H,Dk]`` against ``k [..,KVH,Dk]`` and
    ``v [..,KVH,Dv]`` (the dense slab or pages alike): ``"fp32"`` for fp32;
    for bf16 ``"mma"`` when Dk and Dv are multiples of 8 and 16-byte copies
    can read all three operands (a view may start anywhere and have any
    strides), else ``"simple"``."""
    if q.dtype == torch.float32:
        return "fp32"
    if (q.shape[-1] % 8 == 0 and v.shape[-1] % 8 == 0
            and all(map(copyable, (q, k, v)))):
        return "mma"
    return "simple"


def check_decode_operands(name: str, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          dtypes: tuple[torch.dtype, ...] = DTYPES) -> None:
    """What both decode kernels need of q [B,H,Dk] and K/V [..,KVH,D]."""
    h, dk = q.shape[1], q.shape[2]
    kvh, dv = k.shape[2], v.shape[-1]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in dtypes:
        names = " or ".join("bf16" if t == torch.bfloat16 else "fp32"
                            for t in dtypes)
        raise TypeError(f"{name} takes {names} operands of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if dk > MAX_D or dv > MAX_D or h // kvh > MAX_GROUP:
        raise ValueError(f"{name} takes head dims up to {MAX_D} and up to "
                         f"{MAX_GROUP} query heads per KV head, got Dk={dk}, "
                         f"Dv={dv}, H/KVH={h // kvh}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name} needs the head dim contiguous")
    if kvh > _GRID_LIMIT or q.shape[0] > _GRID_LIMIT:
        raise ValueError(f"{name} grid too large for B={q.shape[0]}, "
                         f"KVH={kvh}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention wants q [B,H,D], k = v "
                         f"[B,T,KVH,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kvh == 0 or h % kvh:
        raise ValueError(f"decode_attention shape mismatch q "
                         f"{tuple(q.shape)} vs cache {tuple(k.shape)}")
    if tuple(valid.shape) != (b, t):
        raise ValueError(f"valid {tuple(valid.shape)} != (B={b}, T={t})")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: torch.Tensor, dtypes: tuple[torch.dtype, ...],
            path: str | None) -> torch.Tensor:
    global launches
    check_decode_operands("decode_attention", q, k, v, dtypes)
    if valid.dtype != torch.bool or valid.stride(-1) != 1:
        raise TypeError(f"decode_attention takes a bool valid mask with "
                        f"contiguous rows, got {valid.dtype} strides "
                        f"{valid.stride()}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0 or k.shape[1] == 0:
        return out.zero_()
    path = path or route(q, k, v)
    decode_attention_cuda(q, k, v, valid, out, path)
    launches += 1
    launches_by_route[path] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """One query token per sequence against the cache: q [B,H,D];
    k, v [B,T,KVH,D]; valid [B,T] bool (True = attended) → [B,H,D]."""
    _check(q, k, v, valid)
    if not use_kernel(q, k, v, valid):
        return decode_attention_ref(q, k, v, valid)
    return _launch(q, k, v, valid, DTYPES, None)


def decode_attention_simple_bf16(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 valid: torch.Tensor) -> torch.Tensor:
    """The simple route (a thread a position, chunks of ``DECODE_CHUNK``)
    at any bf16 shape on the card, so that a measurement can hold the mma
    route against it; counted as a ``simple`` launch."""
    _check(q, k, v, valid)
    if not use_kernel(q, k, v, valid):
        raise ValueError("decode_attention_simple_bf16 needs CUDA tensors")
    return _launch(q, k, v, valid, (torch.bfloat16,), "simple")
