"""Shared traced-kernel cost vocabulary for operator-graph exporters.

One home for the cost constructors that model *weight-streaming* GEMMs —
used by both the hand-built paper workloads (``benchmarks/workloads.py``)
and the config-arch exporter (``models/opgraph_export.py``), so bert/t5 and
the 11 assigned architectures price identical stages identically.

A copy of the JAX package's ``models/export_costs.py`` (the cost-only
exports of the two packages must stay node-for-node identical).

DESIGN.md §2: on TPU the weights of a large layer stream into VMEM; a
stream whose transfer time exceeds the kernel floor is an explicitly
schedulable memory op (the scheduler overlaps it with compute — the paper's
compute/memory overlap, Fig. 3), while smaller weights hide behind the
preceding kernel and stay folded into the GEMM cost.
"""
from __future__ import annotations

from ..core.graph import OpCost, OpGraph, OpKind
from ..core.profiler import gemm_cost


def stream_cost(nbytes: float) -> OpCost:
    """Weight-prefetch DMA (HBM→VMEM): pure read traffic, no flops."""
    return OpCost(flops=0.0, bytes_read=float(nbytes), bytes_written=0.0,
                  vmem_bytes=float(min(nbytes, 8 * 2**20)))


def act_gemm_cost(m: int, k: int, n: int, dtype_bytes: int = 2) -> OpCost:
    """GEMM whose weight traffic is carried by a separate stream op: only
    activation bytes count against HBM (the weight sits in VMEM by the time
    the kernel fires)."""
    base = gemm_cost(m, k, n, dtype_bytes)
    return OpCost(flops=base.flops,
                  bytes_read=float(m * k * dtype_bytes),
                  bytes_written=base.bytes_written,
                  vmem_bytes=base.vmem_bytes,
                  occupancy=base.occupancy)


def streamed_ff(g: OpGraph, name: str, inp: int, root: int,
                m: int, k: int, n: int, fuse: tuple | None = None) -> int:
    """FF-projection pair: weight-stream DMA (off the critical path, rooted
    at the graph input so the scheduler may prefetch arbitrarily early) +
    activation-roofline GEMM."""
    w = g.add(f"{name}_wstream", OpKind.GATHER, [root],
              cost=stream_cost(k * n * 2))
    return g.add(name, OpKind.GEMM, [inp, w], cost=act_gemm_cost(m, k, n),
                 fuse_sig=fuse)
