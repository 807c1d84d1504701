"""Graph Capturer (paper §3.4) — scheduled DAG → ONE CUDA graph.

The paper records a scheduled DNN into a CUDA Graph so a replay pays no
per-op launch overhead, with every stream of the plan a branch of that one
graph.  This module does exactly that on the card, in two phases:

Phase 1, ``_lower`` (capture time, runs once per plan), step for step the
JAX package's lowering:
  * every wave is resolved into a flat list of :class:`Step`s — either one
    payload call or one fused stacked call;
  * per-branch constants (weights) of stacked groups are stacked **once**
    with ``torch.stack`` on the graph's device, so a replay never re-stacks;
  * GEMM-kind fusion groups whose payloads declare ``meta["payload"] ==
    "matmul"`` are routed to the hand-written ``branch_gemm`` CUDA kernel
    (its plain version on CPU tensors);
  * matmul groups whose branches share ``(K, F)`` but differ in row count
    (the MoE expert fan-out with unequal routed token counts) cannot be
    stacked — they lower to ONE ``grouped_gemm`` step: branch inputs are
    concatenated and the kernel walks a tile→group table that is built
    here, once, as a device tensor held by the step;
  * each op gets a slot in a flat list environment and each slot a
    precomputed last-use step, so intermediates are dropped as soon as
    they are dead (inside a CUDA graph their memory is reused by later
    steps of the same recording).

Then ``_plan_lanes`` gives every step its lane, the plan's stream of its
first op (:class:`~repro_torch.core.stream_alloc.StreamPlan`; one lane
without a plan), and the fewest waits that order every cross-lane data
edge: a step waits on the event of a producer step on another lane unless
its lane already knows that lane to be past the producer, through FIFO
order or an earlier wait (a vector clock per lane).  An event is recorded
only after a step some other lane waits on.

Phase 2, the executor, walks the step list:
  * CPU tensors, ``CapturedGraph.fn`` and ``call_uncompiled``: the
    single-stream walk in step order, eagerly, on every call;
  * CUDA tensors: the first call copies the inputs into static buffers and
    records the lane walk (:class:`LaneWalk`) into one
    ``torch.cuda.CUDAGraph``: one stream per lane that holds a step, forked
    from the capturing stream, each step issued on its lane after its
    waits, every lane joined back before the capture ends — so steps on
    different lanes are unordered nodes of the graph.  Every call then
    copies its inputs into the static buffers, replays, and returns clones
    of the outputs (so a second request cannot overwrite the first one's
    result).

Memory across lanes: a step that reads a tensor made on another lane calls
``Tensor.record_stream`` with its own lane's stream before the walk drops
the slot, so the block does not go back to its maker's pool while the
reader may still read it.  Inside a capture PyTorch's allocator defers the
reuse of such a block to the capture's end, so a multi-lane graph's pool
is larger than the one-stream recording's (``CudaGraphReplay.pool_bytes``).

Spans (``repro_torch.trace``, off by default): with tracing on, a call of
the executable is a ``forward`` span holding the eager ``walk`` or the
replay's ``replay.copy_in``, ``replay.device`` (two timing events on the
current stream around ``graph.replay()``, read once the second has
completed, never by waiting, with the program's counters then) with its
host part ``replay.submit``, and ``replay.copy_out``; the first call's recording is ``record`` with
``record.warmup_walk``, ``record.capture``, ``record.pool_bytes`` and
``record.instantiate``.  Off, a replay pays one test of the flag.

Unlike the JAX package there is no rescue rung: a fused route that cannot
be built, an armed ``kernel_compile`` / ``grouped_gemm_route`` fault site,
or a failing replay raises; nor does a lane recording that fails fall back
to one stream.  ``CapturedGraph.degradations`` stays as an (empty) log so
``Session.cache_stats()["degraded_routes"]`` keeps its meaning.  Payloads
and steps must not synchronise with the host or build tensors from Python
values on the card: either breaks the recording.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
from typing import Any, Callable, Mapping, Sequence

import torch

from .. import trace as _trace
from ..kernels.branch_gemm import ops as branch_gemm_ops
from ..kernels.grouped_gemm import ops as grouped_gemm_ops
from ..kernels.decode_attention import ops as decode_attention_ops
from ..kernels.flash_attention import ops as flash_attention_ops
from ..kernels.mamba_scan import ops as mamba_scan_ops
from ..kernels.moe_gemm import ops as moe_gemm_ops
from ..kernels.paged_decode import ops as paged_decode_ops
from ..kernels.rmsnorm import ops as rmsnorm_ops
from ..kernels.rwkv6 import ops as rwkv6_ops
from ..runtime.faults import FaultInjected, FaultPlan, get_active as _active_faults
from ..runtime.guard import DegradationLog
from .fusion import WaveSchedule
from .graph import OpGraph
from .stream_alloc import StreamPlan, count_syncs

# Routing targets for a lowered step.
_CALL = "call"                  # single payload call
_VMAP = "vmap"                  # stacked group via torch.func.vmap'd payload
_BRANCH_GEMM = "branch_gemm"    # stacked group via the fused GEMM kernel
_GROUPED_GEMM = "grouped_gemm"  # ragged-M group via the grouped GEMM kernel

GEMM_KERNELS = ("auto", "kernel", "vmap")


class PlanValidationError(ValueError):
    """The wave schedule handed to :func:`capture` is corrupt (or the
    ``plan_validate`` fault site fired) — the one capture failure the
    session recovers from, by re-scheduling sequentially."""


@dataclasses.dataclass
class Step:
    """One pre-lowered execution step (all decisions made at capture time)."""

    route: str                          # _CALL | _VMAP | _BRANCH_GEMM |
                                        # _GROUPED_GEMM
    fn: Callable[..., Any] | None       # payload (vmapped for _VMAP)
    arg_slots: tuple                    # _CALL: (slot, ...) positional args
                                        # stacked: per-arg tuple of branch slots
    consts: tuple                       # hoisted constants (stacked: tensors
                                        # stacked ONCE at capture time)
    out_slots: tuple[int, ...]          # one slot per branch (singles: one)
    free_slots: tuple[int, ...]         # slots dead after this step
    op_ids: tuple[int, ...]             # provenance (tests / debugging)
    group_sizes: tuple[int, ...] = ()   # _GROUPED_GEMM: per-branch row counts
                                        # (the capture-time offset table)
    table: torch.Tensor | None = None   # _GROUPED_GEMM: the kernel's
                                        # tile→(group, row range) table
    # -- lanes (``_plan_lanes``; a fused step takes its first branch's lane)
    lane: int = 0                       # the plan's stream of op_ids[0]
    waits: tuple[int, ...] = ()         # earlier steps (on other lanes)
                                        # whose events this step waits on
    records_event: bool = False         # another lane waits on this step
    cross_slots: tuple[int, ...] = ()   # consumed slots made on another lane


def _launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, by kernel, and the op graph's
    attention products on the tensor-core route."""
    from ..models import opgraph_export   # models import core: bound late
    counts = {name: ops.launches for name, ops in (
        ("branch_gemm", branch_gemm_ops), ("grouped_gemm", grouped_gemm_ops),
        ("rmsnorm", rmsnorm_ops), ("flash_attention", flash_attention_ops),
        ("decode_attention", decode_attention_ops),
        ("paged_decode", paged_decode_ops), ("moe_gemm", moe_gemm_ops),
        ("rwkv6", rwkv6_ops), ("mamba_scan", mamba_scan_ops))}
    counts["paged_decode_mla"] = paged_decode_ops.mla_launches
    counts["attn_tc_products"] = opgraph_export.attn_tc_products
    return counts


def dag_depth(is_kernel: Mapping[Any, bool],
              edges: Sequence[tuple[Any, Any]]) -> tuple[int, int]:
    """(kernel nodes, depth) of a DAG whose nodes are the keys of
    ``is_kernel``: the depth is the most kernel nodes on one path, the
    other nodes (events, memsets, copies) counting as links only."""
    succ: dict[Any, list] = {n: [] for n in is_kernel}
    indeg = dict.fromkeys(is_kernel, 0)
    for a, b in edges:
        succ[a].append(b)
        indeg[b] += 1
    above = dict.fromkeys(is_kernel, 0)    # most kernels on a path into n
    ready = [n for n, d in indeg.items() if d == 0]
    depth, seen = 0, 0
    while ready:
        n = ready.pop()
        seen += 1
        d = above[n] + int(is_kernel[n])
        depth = max(depth, d)
        for b in succ[n]:
            above[b] = max(above[b], d)
            indeg[b] -= 1
            if indeg[b] == 0:
                ready.append(b)
    if seen != len(is_kernel):
        raise ValueError("the graph has a cycle")
    return sum(map(bool, is_kernel.values())), depth


_CU_GRAPH_NODE_TYPE_KERNEL = 0


def kernel_dag(cuda_graph: int) -> tuple[int, int]:
    """:func:`dag_depth` of a ``cudaGraph_t`` (as the integer
    ``torch.cuda.CUDAGraph.raw_cuda_graph`` returns), read through
    libcuda's ``cuGraphGetNodes``, ``cuGraphGetEdges`` and
    ``cuGraphNodeGetType``."""
    cu = ctypes.CDLL("libcuda.so.1")
    ptr, size, ptrs = ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(
        ctypes.c_void_p)
    cu.cuGraphGetNodes.argtypes = [ptr, ptrs, ctypes.POINTER(size)]
    cu.cuGraphGetEdges.argtypes = [ptr, ptrs, ptrs, ctypes.POINTER(size)]
    cu.cuGraphNodeGetType.argtypes = [ptr, ctypes.POINTER(ctypes.c_int)]
    for f in (cu.cuGraphGetNodes, cu.cuGraphGetEdges, cu.cuGraphNodeGetType):
        f.restype = ctypes.c_int

    def check(err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    graph = ptr(cuda_graph)
    n = size(0)
    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ptr * n.value)()
    check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    m = size(0)
    check(cu.cuGraphGetEdges(graph, None, None, ctypes.byref(m)),
          "cuGraphGetEdges")
    src, dst = (ptr * m.value)(), (ptr * m.value)()
    # libcuda refuses a second call for zero edges (a one-node graph)
    if m.value:
        check(cu.cuGraphGetEdges(graph, src, dst, ctypes.byref(m)),
              "cuGraphGetEdges")
    kind = ctypes.c_int()
    is_kernel = {}
    for node in nodes:
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
              "cuGraphNodeGetType")
        is_kernel[node] = kind.value == _CU_GRAPH_NODE_TYPE_KERNEL
    return dag_depth(is_kernel, list(zip(src, dst)))


class LaneWalk:
    """The step walk with every lane that holds a step on a CUDA stream of
    its own (made once, here), forked from the caller's current stream and
    joined back into it: recorded inside ``torch.cuda.graph`` the lanes
    become concurrent branches of the one graph."""

    def __init__(self, exe: "CapturedGraph", device: torch.device):
        self.streams = {lane: torch.cuda.Stream(device)
                        for lane in sorted({s.lane for s in exe.steps})}
        self.n_waits = sum(len(s.waits) for s in exe.steps)
        self._run = exe.lane_fn

    def __call__(self, *args: Any) -> list[Any]:
        return self._run(self.streams, *args)


class CudaGraphReplay:
    """One recorded ``torch.cuda.CUDAGraph`` of a step walk, with the
    static input buffers it reads and the outputs it writes.

    ``walk`` is a :class:`LaneWalk` (what ``CapturedGraph`` records) or any
    callable that issues its work on the current stream, such as
    ``CapturedGraph.fn``, which records the same steps as one stream.
    ``recorded_launches`` counts the kernel launches recorded into the
    graph (one per fused step; a replay re-runs them without calling the
    wrappers); ``n_lanes`` / ``n_waits`` the streams and cross-lane waits
    recorded; ``pool_bytes`` the memory the graph's private pool holds.
    The graph (``cudaGraph_t``) is kept so :meth:`kernel_dag` can read it."""

    def __init__(self, walk: Callable[..., list], args: Sequence[Any]):
        if not all(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            raise TypeError("a CUDA graph needs every input on the card")
        devices = {a.device for a in args}
        if len(devices) != 1:
            raise ValueError(f"inputs on several devices {sorted(map(str, devices))}")
        device = devices.pop()
        self.n_lanes, self.n_waits = ((len(walk.streams), walk.n_waits)
                                      if isinstance(walk, LaneWalk) else (1, 0))
        with _trace.span("record"):
            self.static_inputs = [a.clone() for a in args]
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with _trace.span("record.warmup_walk"), torch.cuda.stream(side):
                walk(*self.static_inputs)
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            before = _launch_counts()
            # Python's collector must not run inside the capture: freeing a
            # dead graph (an engine dropped in a reference cycle) while a
            # stream is capturing invalidates the capture
            collecting = gc.isenabled()
            gc.disable()
            try:
                with _trace.span("record.capture"), torch.cuda.graph(
                        self.graph):
                    self.static_outputs = walk(*self.static_inputs)
            finally:
                if collecting:
                    gc.enable()
            after = _launch_counts()
            with _trace.span("record.pool_bytes"):
                pool = tuple(self.graph.pool())
                self.pool_bytes = sum(
                    seg["total_size"] for seg in torch.cuda.memory_snapshot()
                    if tuple(seg["segment_pool_id"]) == pool)
            self.recorded_launches = {k: after[k] - before[k] for k in after}
            with _trace.span("record.instantiate"):
                self.graph.instantiate()

    def kernel_dag(self) -> tuple[int, int]:
        """(kernel nodes, depth) of the recorded graph: the depth is the
        most kernel nodes on one dependency path, so a one-stream
        recording has depth == nodes and depth < nodes means at least two
        kernels are unordered."""
        return kernel_dag(self.graph.raw_cuda_graph())

    def __call__(self, args: Sequence[Any]) -> list[torch.Tensor]:
        if _trace.on:
            return self._traced_call(args)
        self._copy_in(args)
        self.graph.replay()
        return [o.clone() for o in self.static_outputs]

    def _copy_in(self, args: Sequence[Any]) -> None:
        for buf, a in zip(self.static_inputs, args):
            if a.shape != buf.shape or a.dtype != buf.dtype:
                raise ValueError(
                    f"input {tuple(a.shape)} {a.dtype} does not match the "
                    f"recorded {tuple(buf.shape)} {buf.dtype}")
            buf.copy_(a)

    def _traced_call(self, args: Sequence[Any]) -> list[torch.Tensor]:
        """The call with its spans: ``replay.device`` times the graph on
        the card between two events on the current stream, its child
        ``replay.submit`` the host inside ``graph.replay()``."""
        with _trace.span("replay.copy_in"):
            self._copy_in(args)
        with _trace.span("replay.device", device=True, counters=True):
            with _trace.span("replay.submit"):
                self.graph.replay()
        with _trace.span("replay.copy_out"):
            return [o.clone() for o in self.static_outputs]


@dataclasses.dataclass
class CapturedGraph:
    """Executable artifact. Call with a dict {input_name: tensor}."""

    graph: OpGraph
    schedule: WaveSchedule
    input_ids: list[int]
    output_ids: list[int]
    fn: Callable[..., Any]           # the step walk (eager, one stream)
    steps: list[Step] = dataclasses.field(default_factory=list)
    # the lane walk, fn(streams: {lane: torch.cuda.Stream}, *args)
    lane_fn: Callable[..., Any] | None = None
    # the plan's lanes (None: every step on lane 0)
    stream_plan: StreamPlan | None = None
    # env slots of the inputs (input_ids order) and of the outputs
    input_slots: tuple[int, ...] = ()
    output_slots: tuple[int, ...] = ()
    # input names in input_ids order, precomputed at capture time so the
    # replay path does no per-call graph walks
    input_names: tuple[str, ...] = ()
    # fallback events; this package takes none (see the module docstring)
    degradations: DegradationLog = dataclasses.field(
        default_factory=DegradationLog)
    # the recorded CUDA graph, made by the first call on CUDA inputs
    replay: CudaGraphReplay | None = None

    def __post_init__(self) -> None:
        if not self.input_names:
            self.input_names = tuple(
                self.graph.nodes[i].name for i in self.input_ids)

    def __call__(self, inputs: Mapping[str, Any]) -> list[Any]:
        if _trace.on:
            with _trace.span("forward", forward=True):
                return self._call(inputs)
        return self._call(inputs)

    def _call(self, inputs: Mapping[str, Any]) -> list[Any]:
        args = self._bind(inputs)
        if not any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            with _trace.span("walk", counters=True):
                return self.fn(*args)
        if self.replay is None:
            device = next(a.device for a in args
                          if isinstance(a, torch.Tensor) and a.is_cuda)
            self.replay = CudaGraphReplay(LaneWalk(self, device), args)
        return self.replay(args)

    def call_uncompiled(self, inputs: Mapping[str, Any]) -> list[Any]:
        """The step walk, eagerly (no CUDA graph)."""
        args = self._bind(inputs)
        return self.fn(*args)

    def _bind(self, inputs: Mapping[str, Any]) -> list[Any]:
        args = []
        for name in self.input_names:
            if name not in inputs:
                raise KeyError(f"missing input {name!r}")
            args.append(inputs[name])
        if len(inputs) != len(self.input_names):
            # a typo'd name would otherwise pass silently whenever the real
            # input happens to be bound too — fail loudly instead
            unknown = sorted(set(inputs) - set(self.input_names))
            if unknown:
                raise KeyError(
                    f"unrecognized input name(s) {unknown}; expected "
                    f"{sorted(self.input_names)}")
        return args

    def program_stats(self) -> dict[str, float]:
        routes = [s.route for s in self.steps]
        return {
            "n_steps": float(len(self.steps)),
            "n_single": float(routes.count(_CALL)),
            "n_vmap": float(routes.count(_VMAP)),
            "n_branch_gemm": float(routes.count(_BRANCH_GEMM)),
            "n_grouped_gemm": float(routes.count(_GROUPED_GEMM)),
        }

    def lane_stats(self) -> dict[str, int]:
        """Lanes holding a step, cross-lane waits, cross-lane data edges
        between steps (distinct producer/consumer step pairs; ``n_waits``
        never exceeds it) and the plan's ``count_syncs`` over all ops."""
        producer = {s: k for k, st in enumerate(self.steps)
                    for s in st.out_slots}
        edges = {(producer[s], k) for k, st in enumerate(self.steps)
                 for s in st.cross_slots}
        return {
            "n_lanes": len({s.lane for s in self.steps}),
            "n_waits": sum(len(s.waits) for s in self.steps),
            "n_cross_edges": len(edges),
            "n_syncs": (count_syncs(self.graph, self.stream_plan)
                        if self.stream_plan is not None else 0),
        }


def _branch_input_shapes(
    graph: OpGraph, group: Sequence[int], arg: int = 0,
) -> list[tuple[int, ...] | None]:
    """Declared ``out_shape`` of each branch's ``arg``-th input producer
    (``None`` where the builder did not declare one)."""
    return [graph.nodes[graph.nodes[g].inputs[arg]].out_shape for g in group]


def _uniform_group(graph: OpGraph, group: Sequence[int]) -> bool:
    """Shared eligibility core for BOTH fused routes (stacked and grouped):
    every op has a payload, the same fuse_sig and arity, and per-branch
    constants of identical shapes AND dtypes (stacking mixed dtypes would
    promote, so the fused group would return a different dtype than
    unfused execution)."""
    if len(group) < 2:
        return False
    first = graph.nodes[group[0]]
    if first.fn is None or first.fuse_sig is None:
        return False
    c0 = first.meta.get("consts", ())
    arity0 = len(first.inputs)
    for g in group:
        n = graph.nodes[g]
        if n.fuse_sig != first.fuse_sig or n.fn is None:
            return False
        if len(n.inputs) != arity0:
            return False
        cg = n.meta.get("consts", ())
        if len(cg) != len(c0):
            return False
        if any(a.shape != b.shape for a, b in zip(cg, c0)):
            return False
        if any(a.dtype != b.dtype for a, b in zip(cg, c0)):
            return False
    return True


def _stack_consts(graph: OpGraph, group: Sequence[int]) -> tuple:
    """Const hoisting: per-branch constants stacked ONCE at capture time, on
    the device they live on."""
    nodes = [graph.nodes[o] for o in group]
    n_consts = len(nodes[0].meta.get("consts", ()))
    return tuple(
        torch.stack([n.meta["consts"][c] for n in nodes])
        for c in range(n_consts))


def _can_stack(graph: OpGraph, group: Sequence[int]) -> bool:
    """A group is stackable if it is uniform (:func:`_uniform_group`) and
    no two branches *declare* different input shapes (``torch.stack`` at
    run time needs equal shapes; ragged matmul groups take the grouped
    route instead).

    Contract: branch-varying parameters (weights) must be declared in
    ``meta["consts"]`` — the capturer stacks them alongside the inputs and
    executes ONE fused payload.  Ops whose closures hide differing state
    must leave ``fuse_sig=None``.
    """
    if not _uniform_group(graph, group):
        return False
    for a in range(len(graph.nodes[group[0]].inputs)):
        known = {s for s in _branch_input_shapes(graph, group, a)
                 if s is not None}
        if len(known) > 1:
            return False
    return True


def _gemm_routable(graph: OpGraph, group: Sequence[int]) -> bool:
    """True iff the stacked group can go to the fused branch-GEMM kernel.

    Contract (explicit opt-in, no payload guessing): every node declares
    ``meta["payload"] == "matmul"`` — payload semantics are exactly
    ``x @ w (+ b)`` with ``consts == (w,)`` or ``(w, b)``, ``w.ndim == 2``.
    """
    for g in group:
        n = graph.nodes[g]
        if n.meta.get("payload") != "matmul" or len(n.inputs) != 1:
            return False
        consts = n.meta.get("consts", ())
        if len(consts) not in (1, 2):
            return False
        if consts[0].dim() != 2:
            return False
        if len(consts) == 2 and consts[1].dim() != 1:
            return False
    return True


def _ragged_group_sizes(
    graph: OpGraph, group: Sequence[int],
) -> tuple[int, ...] | None:
    """Per-branch row counts for the grouped ragged-M GEMM route, or
    ``None`` when the group does not qualify.

    Qualifying groups are matmul-marked (``_gemm_routable``) with uniform
    const shapes/dtypes, whose branch inputs all *declare* 2-D
    ``[M_i, K]`` shapes sharing K but differing in at least one M — the
    unequal-token MoE expert fan-out.  Equal-M groups stay on the stacked
    path (``_can_stack``), which is strictly cheaper.
    """
    if not (_gemm_routable(graph, group) and _uniform_group(graph, group)):
        return None
    shapes = _branch_input_shapes(graph, group)
    if any(s is None or len(s) != 2 for s in shapes):
        return None
    k = graph.nodes[group[0]].meta["consts"][0].shape[0]
    if any(s[1] != k for s in shapes):
        return None
    sizes = tuple(int(s[0]) for s in shapes)
    if len(set(sizes)) < 2:
        return None   # uniform M: the stacked path handles it
    # mixed input dtypes would promote under torch.cat
    dtypes = {graph.nodes[graph.nodes[g].inputs[0]].out_dtype
              for g in group}
    dtypes.discard(None)
    if len(dtypes) > 1:
        return None
    return sizes


def _branch_gemm_step(x: torch.Tensor, w: torch.Tensor,
                      *rest: torch.Tensor) -> torch.Tensor:
    """Fused-GEMM callable for one stacked group, called as
    ``fn(x_stacked, *step.consts)``: the pre-stacked weights ``w: [N, K,
    F]`` (and optionally bias ``b: [N, F]``) flow in through
    ``Step.consts``.  The input arrives stacked ``x: [N, *batch, K]``; batch
    dims are flattened for the kernel's [N, M, K] @ [N, K, F] contract and
    restored after."""
    n, k, f = w.shape
    batch_shape = tuple(x.shape[1:-1])
    out = branch_gemm_ops.branch_gemm(x.reshape(n, -1, k), w)
    out = out.reshape((n,) + batch_shape + (f,))
    if rest:  # bias [N, F] broadcast over batch dims
        b = rest[0]
        out = out + b.reshape((n,) + (1,) * len(batch_shape) + (f,))
    return out


def _grouped_gemm_step(group_sizes: tuple[int, ...]) -> Callable[..., Any]:
    """Ragged fused-GEMM callable for one grouped step, called as
    ``fn([x_0, ..., x_{N-1}], step.table, *step.consts)`` with the
    per-branch 2-D inputs UNstacked (their row counts differ); returns one
    output per branch.  ``group_sizes`` is the capture-time offset table
    the run-time shapes must honor."""
    def fused(xs: Sequence[torch.Tensor], table: torch.Tensor,
              w: torch.Tensor, *rest: torch.Tensor) -> list[torch.Tensor]:
        for x, m in zip(xs, group_sizes):
            if x.shape[0] != m:
                raise ValueError(
                    f"branch rows {x.shape[0]} != captured size {m}")
        outs = grouped_gemm_ops.grouped_gemm_parts(list(xs), w, table)
        if rest:  # per-branch bias [N, F]
            b = rest[0]
            outs = [o + b[i] for i, o in enumerate(outs)]
        return outs

    return fused


def _validate_waves(graph: OpGraph, schedule: WaveSchedule) -> None:
    """The capturer's input contract, packer-agnostic: waves must partition
    the graph and every producer must sit in a strictly earlier wave.  Both
    :func:`repro_torch.core.fusion.build_waves` and ``repack_waves``
    guarantee this; the check catches hand-built or corrupted schedules
    before they lower into a program that reads uninitialized slots."""
    wave_of: dict[int, int] = {}
    for w in schedule.waves:
        for op in w.op_ids:
            if op in wave_of:
                raise ValueError(f"op {op} appears in waves {wave_of[op]} "
                                 f"and {w.index}")
            wave_of[op] = w.index
    if set(wave_of) != set(graph.nodes):
        missing = set(graph.nodes) - set(wave_of)
        raise ValueError(f"wave schedule does not cover ops {sorted(missing)[:5]}")
    for node in graph:
        for p in node.inputs:
            if wave_of[p] >= wave_of[node.op_id]:
                raise ValueError(
                    f"dependency {p}->{node.op_id} not satisfied: producer in "
                    f"wave {wave_of[p]}, consumer in wave {wave_of[node.op_id]}")


def _single_steps(graph: OpGraph, group: Sequence[int],
                  slot_of: dict[int, int]) -> list[Step]:
    """Per-op call steps for groups no fused route takes."""
    out: list[Step] = []
    for op in group:
        node = graph.nodes[op]
        if node.fn is None:
            continue
        out.append(Step(
            route=_CALL, fn=node.fn,
            arg_slots=tuple(slot_of[p] for p in node.inputs),
            consts=tuple(node.meta.get("consts", ())),
            out_slots=(slot_of[op],), free_slots=(),
            op_ids=(op,)))
    return out


def _lower_group(
    graph: OpGraph,
    group: Sequence[int],
    slot_of: dict[int, int],
    gemm_kernel: str,
    faults: FaultPlan | None,
) -> list[Step]:
    """Lower one fusion group to its route: branch_gemm or vmap for a
    stackable group, grouped_gemm for a ragged matmul group, per-op calls
    otherwise.  An armed ``kernel_compile`` / ``grouped_gemm_route`` site
    raises out of capture."""
    if _can_stack(graph, group):
        nodes = [graph.nodes[o] for o in group]
        arity = len(nodes[0].inputs)
        arg_slots = tuple(
            tuple(slot_of[n.inputs[a]] for n in nodes)
            for a in range(arity)
        )
        consts = _stack_consts(graph, group)
        if _gemm_routable(graph, group) and gemm_kernel != "vmap":
            if faults is not None:
                faults.fire("kernel_compile")
            route, fn = _BRANCH_GEMM, _branch_gemm_step
        else:
            route, fn = _VMAP, torch.func.vmap(nodes[0].fn)
        return [Step(
            route=route, fn=fn, arg_slots=arg_slots, consts=consts,
            out_slots=tuple(slot_of[o] for o in group),
            free_slots=(), op_ids=tuple(group))]
    if (gemm_kernel != "vmap"
            and (ragged := _ragged_group_sizes(graph, group)) is not None):
        # ragged-M matmul group: ONE grouped kernel instead of N
        # serialized branches (stacking is impossible here)
        if faults is not None:
            faults.fire("grouped_gemm_route")
        nodes = [graph.nodes[o] for o in group]
        consts = _stack_consts(graph, group)
        return [Step(
            route=_GROUPED_GEMM, fn=_grouped_gemm_step(ragged),
            arg_slots=(tuple(slot_of[n.inputs[0]] for n in nodes),),
            consts=consts,
            out_slots=tuple(slot_of[o] for o in group),
            free_slots=(), op_ids=tuple(group),
            group_sizes=ragged,
            table=grouped_gemm_ops.tile_table(ragged, consts[0].device))]
    return _single_steps(graph, group, slot_of)


def _lower(
    graph: OpGraph,
    schedule: WaveSchedule,
    output_ids: Sequence[int],
    gemm_kernel: str = "auto",
    faults: FaultPlan | None = None,
) -> tuple[list[Step], dict[int, int], int]:
    """Phase 1: wave schedule → pre-lowered step list + slot assignment."""
    slot_of = {op: k for k, op in enumerate(graph.nodes)}
    n_slots = len(slot_of)

    steps: list[Step] = []
    for wave in schedule.waves:
        for group in wave.fusion_groups:
            steps.extend(
                _lower_group(graph, group, slot_of, gemm_kernel, faults))

    # dead-slot analysis: a slot is freed right after its last consuming
    # step — or, for outputs nothing ever consumes (and which aren't program
    # outputs), right after its producing step — unless it backs an output.
    keep = {slot_of[o] for o in output_ids}
    last_use: dict[int, int] = {}
    for k, step in enumerate(steps):
        for s in _consumed(step):
            last_use[s] = k
    free_at: dict[int, list[int]] = {}
    for s, last in last_use.items():
        if s not in keep:
            free_at.setdefault(last, []).append(s)
    for k, step in enumerate(steps):
        dead = [s for s in free_at.get(k, ()) if s not in step.out_slots]
        # unconsumed non-output results die the moment they are produced
        dead += [s for s in step.out_slots
                 if s not in keep and s not in last_use]
        step.free_slots = tuple(dead)
    return steps, slot_of, n_slots


def _consumed(step: Step) -> list[int]:
    """The slots a step reads."""
    if step.route == _CALL:
        return list(step.arg_slots)
    return [s for slots in step.arg_slots for s in slots]


def _plan_lanes(steps: list[Step], stream_plan: StreamPlan | None) -> None:
    """Give every step its lane and its waits (module docstring).

    Each lane keeps a vector clock, ``{lane: last step of that lane known
    finished}``.  A step needs, of every other lane it reads from, that
    lane's latest producer step; it waits on that step's event unless its
    clock already covers it, and a wait merges the producer's clock after
    that step (an event recorded after step p on lane A completes only
    after everything lane A waited on before p).  Producers are taken
    latest first, so one wait can cover an older one."""
    producer: dict[int, int] = {}
    after: list[dict[int, int]] = []      # step k's lane's clock after k
    clocks: dict[int, dict[int, int]] = {}
    for k, step in enumerate(steps):
        step.lane = (stream_plan.stream_of[step.op_ids[0]]
                     if stream_plan is not None else 0)
        clock = clocks.setdefault(step.lane, {})
        need: dict[int, int] = {}         # other lane -> latest producer
        cross = []
        for s in _consumed(step):
            p = producer.get(s)
            if p is None or steps[p].lane == step.lane:
                continue                  # a graph input, or FIFO order
            cross.append(s)
            need[steps[p].lane] = max(need.get(steps[p].lane, -1), p)
        waits = []
        for p in sorted(need.values(), reverse=True):
            if clock.get(steps[p].lane, -1) >= p:
                continue
            waits.append(p)
            steps[p].records_event = True
            for lane, q in after[p].items():
                clock[lane] = max(clock.get(lane, -1), q)
        clock[step.lane] = k
        after.append(dict(clock))
        step.waits = tuple(waits)
        step.cross_slots = tuple(dict.fromkeys(cross))
        for s in step.out_slots:
            producer[s] = k


def run_step(step: Step, env: list[Any]) -> None:
    """Run one step on the current stream: read its slots of ``env``, write
    its outputs' slots."""
    if step.route == _CALL:
        env[step.out_slots[0]] = step.fn(*[env[s] for s in step.arg_slots],
                                         *step.consts)
    elif step.route == _GROUPED_GEMM:
        outs = step.fn([env[s] for s in step.arg_slots[0]], step.table,
                       *step.consts)
        for k, slot in enumerate(step.out_slots):
            env[slot] = outs[k]
    else:
        stacked = [torch.stack([env[s] for s in slots])
                   for slots in step.arg_slots]
        outs = step.fn(*stacked, *step.consts)
        for k, slot in enumerate(step.out_slots):
            env[slot] = _branch(outs, k)


def _record_stream(value: Any, stream: torch.cuda.Stream) -> None:
    """``Tensor.record_stream`` on every tensor of a slot's value."""
    if isinstance(value, torch.Tensor):
        value.record_stream(stream)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _record_stream(v, stream)


def _branch(outs: Any, k: int) -> Any:
    """Branch ``k`` of a stacked result (a tensor or a tuple of them)."""
    if isinstance(outs, (tuple, list)):
        return type(outs)(_branch(o, k) for o in outs)
    return outs[k]


def capture(
    graph: OpGraph,
    schedule: WaveSchedule,
    output_ids: Sequence[int] | None = None,
    gemm_kernel: str = "auto",
    faults: FaultPlan | None = None,
    stream_plan: StreamPlan | None = None,
) -> CapturedGraph:
    """Build the executable from a wave schedule.

    ``stream_plan`` gives the steps their lanes (``stream_of`` of each
    step's first op); without one every step sits on one lane, so the
    recording is one stream.

    ``gemm_kernel`` routes eligible stacked GEMM groups: ``"auto"`` or
    ``"kernel"`` (the fused ``branch_gemm`` kernel; ragged-M matmul groups
    take ``grouped_gemm``) or ``"vmap"`` (the generic stacked payload;
    ragged groups then run as per-branch calls, since they cannot be
    vmapped).

    ``faults`` (default: the process-wide plan, if any) arms the
    ``plan_validate`` / ``kernel_compile`` / ``grouped_gemm_route``
    injection sites; each raises out of capture (``plan_validate`` as a
    :class:`PlanValidationError`, like a real corrupt schedule).
    """
    if gemm_kernel not in GEMM_KERNELS:
        raise ValueError(f"unknown gemm_kernel {gemm_kernel!r}")
    if faults is None:
        faults = _active_faults()
    try:
        if faults is not None:
            # models a corrupted/stale plan arriving at the capturer
            faults.fire("plan_validate")
        graph.validate()
        _validate_waves(graph, schedule)
    except (FaultInjected, ValueError) as exc:
        raise PlanValidationError(str(exc)) from exc
    input_ids = [n.op_id for n in graph if n.fn is None]
    if output_ids is None:
        output_ids = graph.leaves()
    output_ids = list(output_ids)

    steps, slot_of, n_slots = _lower(graph, schedule, output_ids,
                                     gemm_kernel, faults=faults)
    _plan_lanes(steps, stream_plan)
    input_slots = tuple(slot_of[i] for i in input_ids)
    output_slots = tuple(slot_of[o] for o in output_ids)

    def bind(args: Sequence[Any]) -> list[Any]:
        env: list[Any] = [None] * n_slots
        for s, a in zip(input_slots, args):
            env[s] = a
        return env

    def run(*args: Any) -> list[Any]:
        env = bind(args)
        for step in steps:
            run_step(step, env)
            for s in step.free_slots:
                env[s] = None
        return [env[s] for s in output_slots]

    def run_lanes(streams: Mapping[int, torch.cuda.Stream],
                  *args: Any) -> list[Any]:
        env = bind(args)
        base = torch.cuda.current_stream()
        for stream in streams.values():
            stream.wait_stream(base)
        events: dict[int, torch.cuda.Event] = {}
        for k, step in enumerate(steps):
            stream = streams[step.lane]
            for p in step.waits:
                stream.wait_event(events[p])
            with torch.cuda.stream(stream):
                for s in step.cross_slots:
                    _record_stream(env[s], stream)
                run_step(step, env)
            if step.records_event:
                events[k] = stream.record_event()
            for s in step.free_slots:
                env[s] = None
        for stream in streams.values():
            base.wait_stream(stream)
        return [env[s] for s in output_slots]

    return CapturedGraph(
        graph=graph,
        schedule=schedule,
        input_ids=input_ids,
        output_ids=output_ids,
        fn=run,
        steps=steps,
        lane_fn=run_lanes,
        stream_plan=stream_plan,
        input_slots=input_slots,
        output_slots=output_slots,
    )


def run_sequential_uncompiled(
    graph: OpGraph,
    inputs: Mapping[str, Any],
    output_ids: Sequence[int] | None = None,
) -> list[Any]:
    """Eager per-op execution in topo order — the "stock PyTorch" baseline:
    every op is dispatched separately from Python and, on the card, waited
    for (``torch.cuda.synchronize()`` after each op).

    ``output_ids`` selects which ops' results are returned (default: the
    graph's leaves) — pass a :class:`CapturedGraph`'s ``output_ids`` so a
    differential comparison reads the SAME outputs the compiled program
    returns instead of silently re-deriving them.
    """
    env: dict[int, Any] = {}
    sync = any(isinstance(a, torch.Tensor) and a.is_cuda
               for a in inputs.values())
    for i in graph.topological_order():
        node = graph.nodes[i]
        if node.fn is None:
            env[i] = inputs[node.name]
        else:
            consts = node.meta.get("consts", ())
            env[i] = node.fn(*[env[p] for p in node.inputs], *consts)
            if sync:
                torch.cuda.synchronize()
    if output_ids is None:
        output_ids = graph.leaves()
    return [env[o] for o in output_ids]
