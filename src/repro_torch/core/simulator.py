"""Multi-lane execution simulator with an interference model.

The container has no GPU (and a TPU runs one fused region at a time), so the
paper's *wall-clock* stream-concurrency experiments are reproduced on a
calibrated discrete-event simulator, the same methodology the paper's own
analytical model (Eq. 1–4) implies:

* the device executes operators on ``n_lanes`` concurrent lanes (streams);
* each op occupies its stream for ``est_us`` (roofline or measured);
* a *resource cap* models the SM/VMEM pool: the sum of ``resource_demand()``
  of concurrently-executing ops may not exceed ``resource_cap`` — an op whose
  demand does not fit BLOCKS the stream head (the paper's "GPU blocking",
  non-preemptive, Fig. 2);
* *interference* (paper Fig. 3): while >=2 ops of the same intensity class
  run concurrently, each runs slower by ``interference_penalty`` (default
  13% — the paper measures 12.7–13.6%); mixed-class overlap is free;
* cross-stream dependencies cost ``sync_us`` each (the paper's t_overhead).

The simulator consumes exactly the artifacts the real backends consume: a
:class:`StreamPlan` (Alg. 1 / Nimble) and a launch order (Alg. 2 /
baselines), so scheduler comparisons (Fig. 2/5/8, Table 1) are apples to
apples.
"""
from __future__ import annotations

import dataclasses
import heapq

from .graph import IntensityClass, OpGraph
from .profiler import OpProfile
from .stream_alloc import StreamPlan


@dataclasses.dataclass(frozen=True)
class SimConfig:
    resource_cap: float = 128 * 2**20   # VMEM pool (SM-pool analogue)
    interference_penalty: float = 0.13  # paper Fig. 3: ~13%
    sync_us: float = 1.0                # t_overhead per cross-stream event
    launch_us: float = 5.0              # per-op launch cost WITHOUT graph capture
    graph_capture: bool = True          # CUDA-Graph analogue: no launch cost
    # non-preemptive dispatch (paper §2.3 / [11]): kernels dispatch in launch
    # order; one waiting on resources blocks every later launch.  THE
    # mechanism that makes the operator launch order matter (Fig. 2).
    head_of_line: bool = False


@dataclasses.dataclass
class SimResult:
    makespan_us: float
    per_op_start: dict[int, float]
    per_op_end: dict[int, float]
    busy_us: float                      # sum of op durations (utilization numer.)
    n_syncs: int

    def utilization(self, n_lanes: int) -> float:
        return self.busy_us / max(self.makespan_us * n_lanes, 1e-9)


def simulate(
    graph: OpGraph,
    plan: StreamPlan,
    order: list[int],
    profiles: dict[int, OpProfile],
    cfg: SimConfig | None = None,
) -> SimResult:
    """Event-driven simulation.

    Streams are FIFO: each stream executes its ops in `order`-induced
    sequence.  An op starts when (1) its stream head reaches it, (2) all
    predecessors finished (+sync_us if cross-stream), (3) resource fits.
    Interference: an op's duration is stretched by the fraction of its
    lifetime it shares the device with another op of the same class; we apply
    the penalty if any same-class op overlaps (conservative, matches the
    paper's pairwise measurements).
    """
    cfg = cfg or SimConfig()
    pos_in_order = {op: k for k, op in enumerate(order)}
    stream_queues: dict[int, list[int]] = {}
    for op in order:
        stream_queues.setdefault(plan.stream_of[op], []).append(op)

    end: dict[int, float] = {}
    start: dict[int, float] = {}
    stream_free: dict[int, float] = {s: 0.0 for s in stream_queues}
    # running set for resource/interference accounting: (end_t, demand, class, id)
    running: list[tuple[float, float, IntensityClass, int]] = []
    n_syncs = 0
    busy = 0.0

    # process ops in launch order, but an op can only start after its stream
    # predecessor — emulate per-stream program order with stream_free times.
    stream_pos: dict[int, int] = {s: 0 for s in stream_queues}
    remaining = len(order)
    launched: set[int] = set()
    t_cursor = 0.0
    last_start = 0.0   # head-of-line: dispatch times are monotone in order

    def _gc(now: float) -> None:
        nonlocal running
        running = [r for r in running if r[0] > now]

    n_launched_total = 0
    while remaining:
        progressed = False
        # try streams in launch-order priority: pick the op with the smallest
        # global order index whose stream-head it is and whose deps resolved
        candidates: list[tuple[int, int, int]] = []  # (order_pos, stream, op)
        if cfg.head_of_line:
            # non-preemptive dispatch: only the NEXT op in launch order may
            # be placed; if it cannot run yet, everything behind it waits.
            op = order[n_launched_total]
            if all(p in end for p in graph.nodes[op].inputs):
                candidates.append((pos_in_order[op], plan.stream_of[op], op))
        else:
            for s, q in stream_queues.items():
                k = stream_pos[s]
                if k < len(q):
                    op = q[k]
                    if all(p in end for p in graph.nodes[op].inputs):
                        candidates.append((pos_in_order[op], s, op))
        if not candidates:
            # advance time to the earliest running end to unblock deps
            if running:
                t_cursor = min(r[0] for r in running)
                _gc(t_cursor)
                # mark ended ops (they are already in `end`)
                progressed = True
                continue
            raise RuntimeError("deadlock in simulation — invalid schedule")

        candidates.sort()
        scheduled_any = False
        for _, s, op in candidates:
            node = graph.nodes[op]
            prof = profiles[op]
            demand = prof.cost.resource_demand()
            # dependency ready time (+ sync for cross-stream edges)
            dep_t = 0.0
            for p in set(node.inputs):
                t = end[p]
                if plan.stream_of[p] != s:
                    t += cfg.sync_us
                    if op not in launched:
                        n_syncs += 1
                dep_t = max(dep_t, t)
            t0 = max(stream_free[s], dep_t, t_cursor if not running else 0.0)
            if cfg.head_of_line:
                t0 = max(t0, last_start)
            if not cfg.graph_capture:
                t0 += cfg.launch_us
            # resource cap: find earliest time >= t0 when it fits
            horizon = sorted({t0} | {r[0] for r in running if r[0] > t0})
            placed = False
            for t_try in horizon:
                concurrent = [r for r in running if r[0] > t_try]
                used = sum(r[1] for r in concurrent)
                if used + demand <= cfg.resource_cap or not concurrent:
                    # interference check
                    same = any(r[2] is prof.intensity for r in concurrent)
                    dur = prof.est_us * (1.0 + (cfg.interference_penalty if same else 0.0))
                    start[op] = t_try
                    end[op] = t_try + dur
                    running.append((end[op], demand, prof.intensity, op))
                    stream_free[s] = end[op]  # FIFO stream: serializes lane
                    stream_pos[s] += 1
                    launched.add(op)
                    n_launched_total += 1
                    last_start = max(last_start, t_try)
                    busy += dur
                    remaining -= 1
                    placed = True
                    scheduled_any = True
                    break
            if placed:
                break  # re-evaluate candidates after each placement
        if not scheduled_any and not progressed:
            # everything blocked on resources: jump time forward
            if not running:
                raise RuntimeError("resource deadlock — op demand exceeds cap")
            t_cursor = min(r[0] for r in running)
            _gc(t_cursor)

    makespan = max(end.values(), default=0.0)
    return SimResult(
        makespan_us=makespan,
        per_op_start=start,
        per_op_end=end,
        busy_us=busy,
        n_syncs=n_syncs,
    )


def estimate_makespan(
    graph: OpGraph,
    plan: StreamPlan,
    order: list[int],
    profiles: dict[int, OpProfile],
    cfg: SimConfig | None = None,
) -> float:
    """Fast-path cost model: one monotone sweep over the launch order.

    The autotuner's inner loop (``scheduler.autotune``) evaluates dozens of
    candidate (streams, order, packing) triples per graph, so it cannot
    afford :func:`simulate`'s per-op horizon rescans.  This estimator keeps
    the same mechanics — FIFO streams, cross-stream sync cost, the shared
    resource pool, the same-class interference penalty, head-of-line
    dispatch — but places each op exactly once, tracking the running set in
    a single min-heap popped monotonically (O(n log n) total, ≥10× faster
    than :func:`simulate` on multi-thousand-op graphs).

    For ``head_of_line=True`` (dispatch times monotone in launch order) the
    sweep is a faithful reduction of :func:`simulate`; without it the sweep
    processes ops in launch order rather than re-arbitrating stream heads
    per event, so it is an *estimate* — accurate enough to rank candidate
    schedules, which is all the autotuner needs.
    """
    return _sweep(op_tables(graph, plan, profiles), order, cfg or SimConfig())


def op_tables(
    graph: OpGraph,
    plan: StreamPlan,
    profiles: dict[int, OpProfile],
) -> tuple:
    """Dense per-op arrays (op ids are 0..n-1 by construction) feeding
    :func:`_sweep`.  Order-independent, so the autotuner prefetches once per
    stream plan and sweeps every candidate order against the same tables."""
    n = len(graph.nodes)
    stream = [0] * n
    demand = [0.0] * n
    est = [0.0] * n
    is_comp = [False] * n
    inputs: list[tuple[int, ...]] = [()] * n
    stream_of = plan.stream_of
    for op, node in graph.nodes.items():
        p = profiles[op]
        stream[op] = stream_of[op]
        demand[op] = p.cost.resource_demand()
        est[op] = p.est_us
        is_comp[op] = p.intensity is IntensityClass.COMPUTE
        inputs[op] = node.inputs
    return stream, demand, est, is_comp, inputs


class SweepState:
    """Resumable :func:`_sweep` state — the delta re-estimation primitive.

    The sweep places ops strictly in launch-order sequence, so its state
    after a prefix is a pure function of that prefix.  ``scheduler.refine``
    exploits this: it checkpoints (``clone``) the state at wave boundaries
    and re-estimates a perturbed schedule by re-sweeping only the suffix
    behind the edit (``sweep_extend``) instead of the whole order.
    """

    __slots__ = ("end", "stream_free", "active", "used", "n_comp", "n_mem",
                 "last_start", "makespan")

    def __init__(self, n_ops: int):
        self.end = [0.0] * n_ops
        self.stream_free: dict[int, float] = {}
        # running set: min-heap of (end_t, op, demand, is_comp) + aggregates
        self.active: list[tuple[float, int, float, bool]] = []
        self.used = 0.0
        self.n_comp = 0
        self.n_mem = 0
        self.last_start = 0.0
        self.makespan = 0.0

    def clone(self) -> "SweepState":
        s = SweepState.__new__(SweepState)
        s.end = self.end.copy()
        s.stream_free = dict(self.stream_free)
        s.active = list(self.active)   # a copied heap keeps its invariant
        s.used = self.used
        s.n_comp = self.n_comp
        s.n_mem = self.n_mem
        s.last_start = self.last_start
        s.makespan = self.makespan
        return s

    def fork(self) -> "SweepState":
        """Like :meth:`clone` but SHARING the per-op ``end`` array.

        Valid because the sweep only reads ``end[p]`` for producers ``p``
        of the op being placed — which a dependency-valid order has already
        placed *in the same walk* or before the fork point — so entries at
        or beyond the fork point are always rewritten before they are read.
        Forks from one base state may interleave freely under that rule;
        ``clone`` (which copies) is the safe choice when in doubt.  This is
        what makes a refinement candidate's suffix re-estimate O(suffix)
        instead of O(n) per evaluation.
        """
        s = SweepState.__new__(SweepState)
        s.end = self.end                # shared, write-before-read
        s.stream_free = dict(self.stream_free)
        s.active = list(self.active)
        s.used = self.used
        s.n_comp = self.n_comp
        s.n_mem = self.n_mem
        s.last_start = self.last_start
        s.makespan = self.makespan
        return s


def sweep_extend(tables: tuple, ops, cfg: SimConfig,
                 state: SweepState) -> float:
    """Place ``ops`` (the next slice of a launch order) onto ``state``.

    Mutates ``state`` and returns the running makespan.  Chaining
    ``sweep_extend`` calls over consecutive slices of an order is exactly
    equivalent to one :func:`_sweep` over the whole order; every op's
    producers must have been placed by an earlier slice (or this one).
    """
    sync = cfg.sync_us
    launch = 0.0 if cfg.graph_capture else cfg.launch_us
    cap = cfg.resource_cap
    penalty = 1.0 + cfg.interference_penalty
    head_of_line = cfg.head_of_line
    heappush, heappop = heapq.heappush, heapq.heappop

    stream, demand, est, is_comp, inputs = tables
    end = state.end
    stream_free = state.stream_free
    active = state.active
    used = state.used
    n_comp = state.n_comp
    n_mem = state.n_mem
    last_start = state.last_start
    makespan = state.makespan

    for op in ops:
        s = stream[op]
        t0 = stream_free.get(s, 0.0)
        for p in inputs[op]:    # duplicate edges: same max, no dedup cost
            t = end[p]
            if stream[p] != s:
                t += sync
            if t > t0:
                t0 = t
        if head_of_line and last_start > t0:
            t0 = last_start
        t0 += launch
        # retire everything finished by t0 (monotone pop)
        while active and active[0][0] <= t0:
            _, _, d, c = heappop(active)
            used -= d
            if c:
                n_comp -= 1
            else:
                n_mem -= 1
        dem = demand[op]
        # resource admission: advance start to successive completion times
        # until the op fits (an op larger than the cap runs alone, matching
        # simulate()'s empty-device admission).
        while active and used + dem > cap:
            e, _, d, c = heappop(active)
            used -= d
            if c:
                n_comp -= 1
            else:
                n_mem -= 1
            if e > t0:
                t0 = e
        comp = is_comp[op]
        dur = est[op]
        if (n_comp if comp else n_mem) > 0:
            dur *= penalty
        t1 = t0 + dur
        end[op] = t1
        stream_free[s] = t1
        if t0 > last_start:
            last_start = t0
        heappush(active, (t1, op, dem, comp))
        used += dem
        if comp:
            n_comp += 1
        else:
            n_mem += 1
        if t1 > makespan:
            makespan = t1

    state.used = used
    state.n_comp = n_comp
    state.n_mem = n_mem
    state.last_start = last_start
    state.makespan = makespan
    return makespan


def _sweep(tables: tuple, order: list[int], cfg: SimConfig) -> float:
    return sweep_extend(tables, order, cfg, SweepState(len(tables[0])))


def sequential_makespan(
    graph: OpGraph, profiles: dict[int, OpProfile],
    cfg: SimConfig | None = None,
) -> float:
    """T_seq of the paper — one stream, topological order."""
    cfg = cfg or SimConfig()
    total = sum(profiles[i].est_us for i in graph.nodes)
    if not cfg.graph_capture:
        total += cfg.launch_us * len(graph)
    return total
