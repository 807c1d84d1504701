"""Operator DAG intermediate representation.

This is the graph Opara schedules: every node is a DNN operator with a
callable payload (a function of torch tensors), explicit data dependencies,
and a resource profile filled in by the Model Profiler
(:mod:`repro_torch.core.profiler`).

A copy of the JAX package's ``core/graph.py`` with one change: dtypes enter
:meth:`OpGraph.node_signature` through :func:`dtype_name`, so a graph whose
nodes carry ``torch.bfloat16`` and one carrying ``jnp.bfloat16`` (or
``np.float32`` and ``torch.float32``) have the same structural signature.

The IR intentionally mirrors ``torch.fx.Graph`` at the granularity the paper
uses (one node per framework-level operator: a GEMM, a norm, a gather, ...),
not per-HLO.  Models in :mod:`repro_torch.models` emit an ``OpGraph`` for their
block structure via :class:`GraphBuilder`.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Iterable, Mapping, Sequence


def dtype_name(dtype: Any) -> str:
    """Framework-neutral dtype spelling for signatures: ``"bfloat16"`` for
    ``torch.bfloat16``, ``jnp.bfloat16`` and ``np.dtype("bfloat16")`` alike;
    ``"None"`` (``str(None)``) for an undeclared dtype."""
    if dtype is None:
        return "None"
    text = str(dtype)
    if text.startswith("torch."):
        return text[len("torch."):]
    import numpy as np
    try:
        return np.dtype(dtype).name
    except TypeError:
        return text


class OpKind(enum.Enum):
    """Coarse operator taxonomy (used for fusion signatures + intensity)."""

    GEMM = "gemm"              # dense matmul / einsum
    CONV = "conv"              # convolution (stub frontends)
    ATTENTION = "attention"    # fused attention block
    SCAN = "scan"              # linear recurrence (SSM / RWKV)
    NORM = "norm"              # layernorm / rmsnorm
    ELEMENTWISE = "elementwise"
    GATHER = "gather"          # embedding lookup / index select
    SCATTER = "scatter"        # MoE dispatch / combine
    REDUCE = "reduce"          # softmax denominators, pooling, logits reduce
    INPUT = "input"
    OUTPUT = "output"


class IntensityClass(enum.Enum):
    """Paper §3.3: operators are classified compute- vs memory-intensive."""

    COMPUTE = "compute"
    MEMORY = "memory"


@dataclasses.dataclass
class OpCost:
    """Resource demands of one operator.

    GPU Opara profiles (threads, registers, shared memory) per block; the TPU
    analogue (DESIGN.md §2) is (FLOPs, HBM bytes, VMEM working set).

    ``resource_demand()`` is the scalar Alg. 2 sorts on ("least amount of GPU
    resources" in the paper): we use the VMEM working set, the unit that
    fragments on TPU the way SM slots fragment on A100.
    """

    flops: float = 0.0
    bytes_read: float = 0.0
    bytes_written: float = 0.0
    vmem_bytes: float = 0.0          # working-set estimate
    # fraction of the device's parallel compute the op can occupy (GPU: SM
    # occupancy; TPU: MXU/VPU lane utilization).  Small ops occupy little —
    # the paper's Fig. 1 under-utilization — leaving room for concurrent
    # lanes; big-batch ops saturate (Fig. 8 diminishing gains).
    occupancy: float | None = None
    measured_us: float | None = None  # optional measured wall-time

    OCCUPANCY_UNIT = 128 * 2**20     # demand units when occupancy is set

    @property
    def bytes_total(self) -> float:
        return self.bytes_read + self.bytes_written

    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_total, 1.0)

    def resource_demand(self) -> float:
        if self.occupancy is not None:
            return self.occupancy * self.OCCUPANCY_UNIT
        return self.vmem_bytes

    def intensity(self, machine_balance: float) -> IntensityClass:
        if self.arithmetic_intensity() >= machine_balance:
            return IntensityClass.COMPUTE
        return IntensityClass.MEMORY


@dataclasses.dataclass
class OpNode:
    """One operator in the DAG."""

    op_id: int
    name: str
    kind: OpKind
    fn: Callable[..., Any] | None = None   # payload: positional tensors
    inputs: tuple[int, ...] = ()           # producer op_ids (ordered args)
    out_shape: tuple[int, ...] | None = None
    out_dtype: Any = None
    cost: OpCost = dataclasses.field(default_factory=OpCost)
    # Fusion signature: ops with the same non-None signature appearing in the
    # same wave can be horizontally fused (stacked into one kernel).
    fuse_sig: tuple | None = None
    # Free-form metadata (e.g. which weight a GEMM consumes).
    meta: dict = dataclasses.field(default_factory=dict)

    def __hash__(self) -> int:  # allow set membership keyed by identity
        return self.op_id


@dataclasses.dataclass
class _Topology:
    """Memoized topology bundle shared by every pipeline stage."""

    succ: dict[int, list[int]]         # per-edge successors (duplicates kept)
    unique_succ: dict[int, list[int]]  # deduplicated successors
    indeg: dict[int, int]              # unique-edge indegrees
    order: list[int]                   # Kahn order (may be short on cycles)


class OpGraph:
    """A DAG of :class:`OpNode`.  Insertion order is a topological order.

    Invariants (enforced by :meth:`validate` and hypothesis tests):
      * acyclic — every edge points from a lower to a higher ``op_id``
        (builders always reference already-created nodes);
      * ``inputs`` of a node only reference existing nodes.
    """

    def __init__(self, name: str = "graph") -> None:
        self.name = name
        self.nodes: dict[int, OpNode] = {}
        self._next_id = 0
        # Memoized topology (successors / indegrees / topo order).  Every
        # pipeline stage (validate → profile → alloc → order → waves →
        # capture) walks the same DAG; without the cache schedule() is
        # O(k·(V+E)) with k = number of stages.  Invalidated by add().
        self._topo: _Topology | None = None
        # Memoized structural node signature (compiled-plan cache key part);
        # also invalidated by add().  _sig_digest is its sha1 — cache keys
        # embed the digest so probing the plan/executable LRUs does not
        # re-hash a multi-thousand-entry nested tuple per lookup.
        self._node_sig: tuple | None = None
        self._sig_digest: str | None = None
        # Fingerprint of the measured-profile table currently hydrated onto
        # node costs (None = analytic state).  Set/cleared by the profiler's
        # apply/detach lifecycle; cache keys combine it with node_signature()
        # so calibrated and uncalibrated plans never collide while the raw
        # timings stay OUT of the structural signature.
        self.calibration_fp: tuple | None = None

    # -- construction -------------------------------------------------------
    def add(
        self,
        name: str,
        kind: OpKind,
        inputs: Sequence[int] = (),
        fn: Callable[..., Any] | None = None,
        out_shape: tuple[int, ...] | None = None,
        out_dtype: Any = None,
        cost: OpCost | None = None,
        fuse_sig: tuple | None = None,
        **meta: Any,
    ) -> int:
        for i in inputs:
            if i not in self.nodes:
                raise ValueError(f"op {name!r}: unknown input id {i}")
        op_id = self._next_id
        self._next_id += 1
        self._topo = None       # invalidate memoized topology
        self._node_sig = None   # ... and the structural signature
        self._sig_digest = None
        if self.calibration_fp is not None:
            # structural mutation invalidates any hydrated measured profile
            # (the table no longer covers the graph) — drop back to analytic
            for n in self.nodes.values():
                n.cost.measured_us = None
            self.calibration_fp = None
        self.nodes[op_id] = OpNode(
            op_id=op_id,
            name=name,
            kind=kind,
            fn=fn,
            inputs=tuple(inputs),
            out_shape=out_shape,
            out_dtype=out_dtype,
            cost=cost or OpCost(),
            fuse_sig=fuse_sig,
            meta=dict(meta),
        )
        return op_id

    # -- topology queries ----------------------------------------------------
    def __len__(self) -> int:
        return len(self.nodes)

    def __iter__(self) -> Iterable[OpNode]:
        return iter(self.nodes.values())

    def predecessors(self, op_id: int) -> tuple[int, ...]:
        return self.nodes[op_id].inputs

    # -- memoized topology ---------------------------------------------------
    def _topology(self) -> "_Topology":
        """Compute (once) successors, unique successors, indegrees and the
        Kahn topological order.  All public topology queries read this cache;
        ``add()`` invalidates it.  Returned structures are SHARED — callers
        must not mutate them (use the public accessors, which copy where the
        call convention requires a private mutable map)."""
        if self._topo is None:
            succ: dict[int, list[int]] = {i: [] for i in self.nodes}
            usucc: dict[int, list[int]] = {i: [] for i in self.nodes}
            indeg: dict[int, int] = {}
            for node in self.nodes.values():
                uniq = set(node.inputs)
                indeg[node.op_id] = len(uniq)
                for p in node.inputs:
                    succ[p].append(node.op_id)
                for p in uniq:
                    usucc[p].append(node.op_id)

            import heapq

            work = dict(indeg)
            ready = [i for i, d in work.items() if d == 0]
            heapq.heapify(ready)
            out: list[int] = []
            while ready:
                i = heapq.heappop(ready)
                out.append(i)
                for s in usucc[i]:
                    work[s] -= 1
                    if work[s] == 0:
                        heapq.heappush(ready, s)
            self._topo = _Topology(succ=succ, unique_succ=usucc, indeg=indeg,
                                   order=out)
        return self._topo

    def successors_map(self) -> dict[int, list[int]]:
        """op_id -> successor ids (one entry per edge, duplicates kept).
        Shared cache — treat as read-only."""
        return self._topology().succ

    def unique_successors_map(self) -> dict[int, list[int]]:
        """op_id -> unique successor ids.  Shared cache — read-only."""
        return self._topology().unique_succ

    def indegree_map(self) -> dict[int, int]:
        """Fresh copy (callers decrement it during scheduling)."""
        return dict(self._topology().indeg)

    def roots(self) -> list[int]:
        return [i for i, n in self.nodes.items() if not n.inputs]

    def leaves(self) -> list[int]:
        succ = self._topology().succ
        return [i for i in self.nodes if not succ[i]]

    def topological_order(self) -> list[int]:
        """Kahn order with FIFO tie-break == insertion order (the paper's
        default "topological sorting order" baseline).  Memoized; raises on
        cycles."""
        topo = self._topology()
        if len(topo.order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return list(topo.order)

    def depth_first_order(self) -> list[int]:
        """Depth-first topological order (paper Fig. 2 "order 1" baseline)."""
        topo = self._topology()
        indeg = dict(topo.indeg)
        stack = sorted((i for i, d in indeg.items() if d == 0), reverse=True)
        out: list[int] = []
        while stack:
            i = stack.pop()
            out.append(i)
            for s in sorted(topo.unique_succ[i], reverse=True):
                indeg[s] -= 1
                if indeg[s] == 0:
                    stack.append(s)
        if len(out) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return out

    def invalidate_signature(self) -> None:
        """Must be called after mutating structural node fields in place
        (analytic costs, fusion signatures, payloads/consts) — ``add()`` is
        the only mutation the signature cache sees on its own.  Measured
        timings are NOT structural: the profiler's apply/detach lifecycle
        tracks them via ``calibration_fp`` instead."""
        self._node_sig = None
        self._sig_digest = None

    def node_signature(self) -> tuple:
        """Memoized structural fingerprint of every node: everything the
        scheduling pipeline reads (kind, edges, shapes, dtypes, fusion
        signature, analytic cost, payload marker, const shapes) and nothing
        it doesn't (weight values, payload identities, measured timings —
        those are tracked separately via ``calibration_fp`` so hydrating a
        measured profile does not change the graph's structural identity).
        The compiled-plan and calibration caches on :class:`repro_torch.core.Session`
        build their keys from this."""
        if self._node_sig is None:
            self._node_sig = tuple(
                (
                    n.kind.value,
                    n.inputs,
                    n.out_shape,
                    dtype_name(n.out_dtype),
                    n.fuse_sig,
                    # analytic cost fields + resource_demand(), the scalar
                    # the wave repacker admits on.  Redundant with occupancy/
                    # vmem_bytes TODAY, but pinned explicitly so a future
                    # resource_demand() reading inputs outside this tuple
                    # cannot silently escape the plan/autotune cache keys.
                    (n.cost.flops, n.cost.bytes_read, n.cost.bytes_written,
                     n.cost.vmem_bytes, n.cost.occupancy,
                     n.cost.resource_demand()),
                    n.fn is None,
                    n.meta.get("payload"),
                    tuple(tuple(getattr(c, "shape", ()))
                          for c in n.meta.get("consts", ())),
                )
                for n in self.nodes.values()
            )
        return self._node_sig

    def signature_digest(self) -> str:
        """Memoized sha1 of :meth:`node_signature` — the compact component
        plan/executable cache keys embed.  Probing an LRU hashes the whole
        key; on multi-thousand-op graphs hashing the raw nested tuple costs
        ~1 ms per probe, so keys carry this 40-char digest instead (the full
        tuple remains the calibration cache's key part, where its repr also
        serves as the on-disk collision check)."""
        if self._sig_digest is None:
            import hashlib

            self._sig_digest = hashlib.sha1(
                repr(self.node_signature()).encode()).hexdigest()
        return self._sig_digest

    def input_signature(self, inputs: Mapping[int, Any]) -> tuple:
        """Shape/dtype fingerprint of a concrete input binding — the
        ``measured_inputs`` part of the calibration-cache key.  Two bindings
        with identical shapes and dtypes are interchangeable for profiling
        (operator wall time depends on geometry, not values)."""
        sig = []
        for i in sorted(inputs):
            if i not in self.nodes:
                raise ValueError(f"input binding references unknown op id {i}")
            a = inputs[i]
            shape = getattr(a, "shape", None)
            dtype = getattr(a, "dtype", None)
            if shape is None or dtype is None:
                import numpy as _np
                arr = _np.asarray(a)
                shape, dtype = arr.shape, arr.dtype
            sig.append((i, tuple(shape), dtype_name(dtype)))
        return tuple(sig)

    def validate(self) -> None:
        for node in self.nodes.values():
            for p in node.inputs:
                if p not in self.nodes:
                    raise ValueError(f"dangling edge {p}->{node.op_id}")
                if p >= node.op_id:
                    raise ValueError(
                        f"non-topological edge {p}->{node.op_id}; graph must be "
                        "built producer-first"
                    )
        self.topological_order()  # raises on cycle

    def max_width(self) -> int:
        """Maximum antichain width by longest-path leveling (the paper notes
        Alg. 1's inner loop is bounded by graph width, typically < 20)."""
        level: dict[int, int] = {}
        for i in self.topological_order():
            node = self.nodes[i]
            level[i] = 1 + max((level[p] for p in node.inputs), default=-1)
        from collections import Counter

        return max(Counter(level.values()).values()) if level else 0

    def critical_path_cost(self, duration: Mapping[int, float]) -> float:
        """Lower bound on makespan given per-op durations."""
        best: dict[int, float] = {}
        for i in self.topological_order():
            node = self.nodes[i]
            best[i] = duration[i] + max((best[p] for p in node.inputs), default=0.0)
        return max(best.values(), default=0.0)


def sequential_chain(n: int, kind: OpKind = OpKind.GEMM) -> OpGraph:
    """Tiny helper used by tests: a pure chain (no parallelism)."""
    g = OpGraph("chain")
    prev: list[int] = []
    for i in range(n):
        prev = [g.add(f"op{i}", kind, inputs=prev)]
    return g
