"""ctypes binding of the CUDA decode attention (``csrc/attention.cu``).

Replaces ``src/repro/kernels/decode_attention/kernel.py:decode_attention_pallas``:
flash-decoding, one block per (split of the cache positions, KV head, batch
row) serving all query heads of the group, then a combine of the splits.
The cache ``[B,T,KVH,D]`` is read in place.  Three routes, one entry point
each: ``mma`` (bf16: :func:`split_len` positions a block staged by
``cp.async`` in 16-position tiles, tensor-core products, the splits of a
(row, KV head) one thread-block cluster that combines them in distributed
shared memory), ``simple`` (bf16, any D up to 128: chunks of
``DECODE_CHUNK`` positions, a thread a position, partials through a scratch
buffer and a second kernel) and ``fp32`` (the simple route's structure in
fp32).  Bound and design notes are in the CUDA source.
"""
from __future__ import annotations

import torch

from .. import DECODE_CHUNK, DECODE_MAX_SPLITS, DECODE_TILE
from .._build import library, sm_count, stream_of, strides

_ENTRY = {"mma": "decode_attention_bf16",
          "simple": "decode_attention_simple_bf16",
          "fp32": "decode_attention_f32"}


def split_len(b: int, kvh: int, t: int, sms: int) -> int:
    """Positions each block of the mma route walks: as many splits of the
    ``t`` positions as fit one block per SM over the ``b × kvh`` (row, KV
    head) pairs (at least one, at most ``DECODE_MAX_SPLITS``), each a whole
    number of ``DECODE_TILE``-position tiles counted from position 0.  A
    function of these four numbers alone, so a paged decode over
    ``MAXP·ps == T`` positions splits as the dense one.  One block an SM
    measured faster than two at both serving shapes (PERF.md §6)."""
    pairs = max(1, b * kvh)
    n = max(1, min(sms // pairs, -(-t // DECODE_TILE), DECODE_MAX_SPLITS))
    return -(-(-(-t // n)) // DECODE_TILE) * DECODE_TILE


def scratch(route: str, b: int, h: int, kvh: int, t: int, dv: int,
            device: torch.device
            ) -> tuple[torch.Tensor | None, tuple[int, ...]]:
    """For a launch over ``t`` positions: the split-KV scratch and the
    arguments the route takes after the scale.  The simple and fp32 routes
    take a scratch of, per (row, head, chunk of ``DECODE_CHUNK``), the fp32
    partial output, then its max and sum (``torch.empty``, so a launch
    inside a CUDA graph takes it from the graph's pool), and nothing more;
    the mma route keeps its partials on chip (no scratch) and takes its
    positions per block."""
    if route == "mma":
        return None, (split_len(b, kvh, t, sm_count(device)),)
    n_chunks = -(-t // DECODE_CHUNK)
    return torch.empty(b * h * n_chunks * (dv + 2), dtype=torch.float32,
                       device=device), ()


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor, out: torch.Tensor,
                          route: str) -> None:
    """Launch ``route`` on the current stream; the wrapper has checked the
    operands."""
    b, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    part, tail = scratch(route, b, h, kvh, t, d, q.device)
    st = strides(q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
                 valid.stride(0), out.stride(0), out.stride(1))
    fn = getattr(library(), _ENTRY[route])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
             None if part is None else part.data_ptr(), out.data_ptr(), b, h,
             kvh, t, d, st, d ** -0.5, *tail, stream_of(q))
    if err != 0:
        raise RuntimeError(f"decode_attention {route} launch failed: CUDA "
                           f"error {err}")
