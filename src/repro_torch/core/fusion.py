"""Wave construction + horizontal fusion.

DESIGN.md §2: on TPU, "N operators running concurrently on N streams" is
realized by packing independent operators into a **wave** and fusing
same-signature ops in a wave into ONE batched kernel (stacked GEMM /
grouped einsum).  This is the TPU-native mechanism that recovers the MXU
under-utilization the paper's Fig. 1 measures for small kernels.

Waves are built from the Opara launch order: walk ops in launch order and
place each op in the earliest wave after all of its producers' waves, capped
by ``max_lanes`` (the stream count).  Ops in one wave are mutually
independent by construction.

Fusion groups: within a wave, ops sharing ``fuse_sig`` (same kind + same
operand shapes/dtype) form one group executed as a single stacked op by the
capturer (or routed to the `branch_gemm` Pallas kernel on TPU).

Two packers:

* :func:`build_waves` — launch-order bucketing capped by lane count only
  (the historical packer; still the ``repack=False`` baseline the autotuner
  compares against);
* :func:`repack_waves` — resource- and interference-aware: a wave admits an
  op only while the wave's summed ``resource_demand()`` stays under
  ``SimConfig.resource_cap``, and ready ops are drawn alternately from the
  memory- and compute-intensive pools (greedy complementary fill) so
  co-resident ops mix intensity classes and the simulator's same-class
  interference penalty stops firing on every wave.
"""
from __future__ import annotations

import dataclasses
import heapq

from .graph import IntensityClass, OpGraph
from .profiler import OpProfile
from .simulator import SimConfig
from .stream_alloc import StreamPlan


@dataclasses.dataclass
class Wave:
    index: int
    op_ids: list[int]
    fusion_groups: list[list[int]]  # partition of op_ids


@dataclasses.dataclass
class WaveSchedule:
    waves: list[Wave]

    @property
    def n_waves(self) -> int:
        return len(self.waves)

    @property
    def n_fused_kernels(self) -> int:
        return sum(len(w.fusion_groups) for w in self.waves)

    def flat_order(self) -> list[int]:
        return [op for w in self.waves for op in w.op_ids]


def build_waves(
    graph: OpGraph,
    plan: StreamPlan,
    order: list[int],
    max_lanes: int | None = None,
) -> WaveSchedule:
    """Greedy wave packing honoring the launch order.

    wave_of[op] = max(wave_of[producers]) + 1, but never earlier than an op
    launched before it *in the same stream* (streams stay FIFO), and each
    wave holds at most ``max_lanes`` ops (hardware lanes = streams).
    """
    if max_lanes is None:
        max_lanes = max(plan.n_streams, 1)
    wave_of: dict[int, int] = {}
    last_wave_in_stream: dict[int, int] = {}
    load: dict[int, int] = {}  # wave -> #ops
    for op in order:
        node = graph.nodes[op]
        w = 0
        for p in node.inputs:
            w = max(w, wave_of[p] + 1)
        s = plan.stream_of[op]
        if s in last_wave_in_stream:
            w = max(w, last_wave_in_stream[s] + 1)
        while load.get(w, 0) >= max_lanes:
            w += 1
        wave_of[op] = w
        last_wave_in_stream[s] = w
        load[w] = load.get(w, 0) + 1

    # single-pass bucketing: `order` is walked once; ops land in their wave
    # bucket in launch order (was an O(n_waves · n_ops) rescan).
    buckets: dict[int, list[int]] = {}
    for op in order:
        buckets.setdefault(wave_of[op], []).append(op)
    waves: list[Wave] = []
    for k in sorted(buckets):
        ops = buckets[k]
        waves.append(Wave(index=len(waves), op_ids=ops,
                          fusion_groups=_group(graph, ops)))
    return WaveSchedule(waves=waves)


def repack_waves(
    graph: OpGraph,
    plan: StreamPlan,
    order: list[int],
    profiles: dict[int, OpProfile],
    cfg: SimConfig | None = None,
    max_lanes: int | None = None,
    group: bool = True,
) -> WaveSchedule:
    """Resource- and interference-aware wave repacking.

    Waves are built one at a time from the ready frontier (ops whose
    producers all sit in *closed* waves), so dependencies hold by
    construction.  Admission into the open wave requires the wave's summed
    ``resource_demand()`` to stay under ``cfg.resource_cap`` (an op whose
    demand alone exceeds the cap gets a wave to itself — the simulator's
    empty-device admission rule).  Ready ops live in two pools keyed by
    intensity class; each draw prefers the class that balances the wave
    (greedy complementary fill), with the launch order breaking ties inside
    a pool — so Algorithm 2's resource-ascending order survives within each
    class while waves deliberately mix classes.

    Fusion groups are recomputed per repacked wave: same-signature ops that
    still co-reside stack into one kernel; ops a resource boundary separated
    fall back to per-branch steps in the capturer automatically.

    ``group=False`` skips the per-wave fusion grouping and emits empty
    ``fusion_groups`` — for callers that only rank candidate packings by
    ``flat_order()`` (autotune's repack leg, ``scheduler.refine``'s
    rebalance ladder) and regroup just the winner via
    :func:`regroup_waves`.
    """
    cfg = cfg or SimConfig()
    if max_lanes is None:
        max_lanes = max(plan.n_streams, 1)
    cap = cfg.resource_cap
    indeg = graph.indegree_map()
    succ = graph.unique_successors_map()

    # hot-loop precompute on dense op-id-indexed lists: the autotuner repacks
    # the same graph once per order candidate, so per-op attribute chases and
    # dict hashing add up on large graphs
    n = len(graph.nodes)
    pos = [0] * n
    for k, op in enumerate(order):
        pos[op] = k
    demand = [0.0] * n
    is_mem = [False] * n
    for op, p in profiles.items():
        demand[op] = p.cost.resource_demand()
        is_mem[op] = p.intensity is IntensityClass.MEMORY
    pool_mem: list[tuple[int, int]] = []
    pool_comp: list[tuple[int, int]] = []

    def push(op: int) -> None:
        heapq.heappush(pool_mem if is_mem[op] else pool_comp, (pos[op], op))

    for op, d in indeg.items():
        if d == 0:
            push(op)

    waves: list[Wave] = []
    while pool_mem or pool_comp:
        # fast path: a one-op ready frontier (the common case in chain-like
        # regions, where most waves come out singleton) — the general loop
        # below would reach the identical wave through pool selection,
        # skipped-list bookkeeping and a sort
        if len(pool_mem) + len(pool_comp) == 1:
            op = (pool_mem or pool_comp).pop()[1]
            waves.append(Wave(
                index=len(waves), op_ids=[op],
                fusion_groups=[[op]] if group else []))
            for s in succ[op]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    push(s)
            continue
        wave_ops: list[int] = []
        used = 0.0
        n_mem = n_comp = 0
        skipped_mem: list[tuple[int, int]] = []
        skipped_comp: list[tuple[int, int]] = []
        while len(wave_ops) < max_lanes:
            # complementary fill: draw from the class the wave has fewer of
            if n_mem <= n_comp:
                pool = pool_mem if pool_mem else pool_comp
            else:
                pool = pool_comp if pool_comp else pool_mem
            if not pool:
                break
            item = heapq.heappop(pool)
            op = item[1]
            mem = is_mem[op]
            if wave_ops and used + demand[op] > cap:
                # does not fit — defer to the next wave
                (skipped_mem if mem else skipped_comp).append(item)
                continue
            wave_ops.append(op)
            used += demand[op]
            if mem:
                n_mem += 1
            else:
                n_comp += 1
        for item in skipped_mem:
            heapq.heappush(pool_mem, item)
        for item in skipped_comp:
            heapq.heappush(pool_comp, item)
        # close the wave: successors of its ops become ready for the next
        wave_ops.sort(key=pos.__getitem__)   # list.__getitem__: op -> rank
        waves.append(Wave(index=len(waves), op_ids=wave_ops,
                          fusion_groups=_group(graph, wave_ops) if group
                          else []))
        for op in wave_ops:
            for s in succ[op]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    push(s)
    return WaveSchedule(waves=waves)


def _group(graph: OpGraph, ops: list[int]) -> list[list[int]]:
    groups: dict[object, list[int]] = {}
    singles: list[list[int]] = []
    for op in ops:
        sig = graph.nodes[op].fuse_sig
        if sig is None:
            singles.append([op])
        else:
            groups.setdefault(sig, []).append(op)
    return list(groups.values()) + singles


def regroup_waves(graph: OpGraph, sched: WaveSchedule) -> WaveSchedule:
    """Recompute fusion groups for every wave — the companion of
    ``repack_waves(..., group=False)``: rank candidates groupless, then
    regroup only the adopted winner."""
    return WaveSchedule(waves=[
        Wave(index=k, op_ids=list(w.op_ids),
             fusion_groups=_group(graph, w.op_ids))
        for k, w in enumerate(sched.waves)
    ])


class WaveEditor:
    """Incremental wave-schedule editing for ``scheduler.refine``.

    Holds a wave schedule as mutable per-wave op lists plus O(1)-updatable
    aggregates (op→wave map, per-wave summed ``resource_demand()`` and
    intensity-class counts), so dependency / resource-cap / lane feasibility
    of a local edit is checked in O(degree) instead of re-running a packer.

    Edits are *local*: every candidate replaces a contiguous slice of waves
    ``lists[start : start + n_replaced]`` with replacement lists, leaving
    everything before ``start`` untouched — which is exactly what lets the
    refiner re-estimate only the suffix via ``simulator.SweepState``
    checkpoints.  Candidates are **proposed** as plain data (no mutation);
    only an accepted edit is applied, after which the op→wave map and
    aggregates are rebuilt for the suffix.

    Fusion groups are cached per wave and recomputed only for waves an
    accepted edit touched (``schedule()`` emits the final
    :class:`WaveSchedule`).
    """

    def __init__(
        self,
        graph: OpGraph,
        waves: WaveSchedule,
        profiles: dict[int, OpProfile],
        cfg: SimConfig | None = None,
        max_lanes: int | None = None,
    ):
        cfg = cfg or SimConfig()
        self.graph = graph
        self.cap = cfg.resource_cap
        self.max_lanes = max_lanes          # None → unbounded lanes
        self.lists: list[list[int]] = [list(w.op_ids) for w in waves.waves
                                       if w.op_ids]
        self._groups: list[list[list[int]] | None] = [
            [list(grp) for grp in w.fusion_groups] for w in waves.waves
            if w.op_ids]
        self.succ = graph.unique_successors_map()
        n = len(graph.nodes)
        self.demand = [0.0] * n
        self.is_mem = [False] * n
        for op, p in profiles.items():
            self.demand[op] = p.cost.resource_demand()
            self.is_mem[op] = p.intensity is IntensityClass.MEMORY
        # rank in the seed wave-major order: the stable in-wave sort key
        self.pos = [0] * n
        for k, op in enumerate(op for w in self.lists for op in w):
            self.pos[op] = k
        self.wave_of = [0] * n
        self.wdemand: list[float] = []
        self.wmem: list[int] = []
        self.wcomp: list[int] = []
        self._reindex(0)
        self.n_edits = 0

    # -- state ---------------------------------------------------------------
    @property
    def n_waves(self) -> int:
        return len(self.lists)

    def flat_order(self) -> list[int]:
        return [op for w in self.lists for op in w]

    def _reindex(self, start: int) -> None:
        del self.wdemand[start:]
        del self.wmem[start:]
        del self.wcomp[start:]
        for k in range(start, len(self.lists)):
            d, m, c = 0.0, 0, 0
            for op in self.lists[k]:
                self.wave_of[op] = k
                d += self.demand[op]
                if self.is_mem[op]:
                    m += 1
                else:
                    c += 1
            self.wdemand.append(d)
            self.wmem.append(m)
            self.wcomp.append(c)

    def apply(self, start: int, n_replaced: int,
              replacement: list[list[int]]) -> None:
        """Commit an accepted edit: splice ``replacement`` (empty waves are
        dropped) over ``lists[start:start+n_replaced]`` and rebuild the
        op→wave map and aggregates for the suffix."""
        repl = [list(w) for w in replacement if w]
        self.lists[start:start + n_replaced] = repl
        self._groups[start:start + n_replaced] = [None] * len(repl)
        self._reindex(start)
        self.n_edits += 1

    # -- candidate edits (pure proposals, no mutation) -----------------------
    def _fits_lanes(self, n_ops: int) -> bool:
        return self.max_lanes is None or n_ops <= self.max_lanes

    def _fits_cap(self, total_demand: float, n_ops: int) -> bool:
        # a lone op larger than the cap runs alone (simulate()'s
        # empty-device admission), so singleton waves are always legal
        return n_ops <= 1 or total_demand <= self.cap

    def _interleave(self, ops: list[int]) -> list[int]:
        """Class-alternating in-wave order (the repacker's complementary
        fill): under head-of-line dispatch, neighbors in the launch order
        are the ops most likely to overlap, so alternating classes is what
        keeps the same-class interference penalty from firing."""
        mem = sorted((o for o in ops if self.is_mem[o]), key=self.pos.__getitem__)
        comp = sorted((o for o in ops if not self.is_mem[o]), key=self.pos.__getitem__)
        out: list[int] = []
        take_mem = bool(mem) and (not comp or self.pos[mem[0]] <= self.pos[comp[0]])
        while mem and comp:
            out.append(mem.pop(0) if take_mem else comp.pop(0))
            take_mem = not take_mem
        return out + mem + comp

    def merge_candidate(self, j: int) -> list[list[int]] | None:
        """Merge wave ``j+1`` into wave ``j`` (class-interleaved)."""
        a, b = self.lists[j], self.lists[j + 1]
        if not self._fits_lanes(len(a) + len(b)):
            return None
        if not self._fits_cap(self.wdemand[j] + self.wdemand[j + 1],
                              len(a) + len(b)):
            return None
        nodes = self.graph.nodes
        for op in b:            # no edge may cross the vanished boundary
            for p in nodes[op].inputs:
                if self.wave_of[p] == j:
                    return None
        return [self._interleave(a + b)]

    def migrate_candidates(self, j: int, limit: int = 2) -> list[list[list[int]]]:
        """Pull ops of wave ``j+1`` forward into wave ``j``, minority
        intensity class first (each proposal moves ONE op)."""
        a, b = self.lists[j], self.lists[j + 1]
        if not self._fits_lanes(len(a) + 1) or len(b) <= 1:
            return []
        nodes = self.graph.nodes
        prefer_mem = self.wmem[j] <= self.wcomp[j]
        movable = [
            op for op in b
            if self._fits_cap(self.wdemand[j] + self.demand[op], len(a) + 1)
            and not any(self.wave_of[p] == j for p in nodes[op].inputs)
        ]
        movable.sort(key=lambda o: (self.is_mem[o] != prefer_mem, self.pos[o]))
        key = self.pos.__getitem__
        return [[sorted(a + [op], key=key), [o for o in b if o != op]]
                for op in movable[:limit]]

    def push_candidates(self, j: int, limit: int = 1) -> list[list[list[int]]]:
        """Defer ops of wave ``j`` into wave ``j+1`` (class rebalancing in
        the other direction — e.g. to break up a same-class pile-up)."""
        a, b = self.lists[j], self.lists[j + 1]
        if not self._fits_lanes(len(b) + 1) or len(a) <= 1:
            return []
        prefer_mem = self.wmem[j + 1] <= self.wcomp[j + 1]
        movable = [
            op for op in a
            if self._fits_cap(self.wdemand[j + 1] + self.demand[op], len(b) + 1)
            and not any(self.wave_of[s] == j + 1 for s in self.succ[op])
        ]
        movable.sort(key=lambda o: (self.is_mem[o] != prefer_mem, self.pos[o]))
        key = self.pos.__getitem__
        return [[[o for o in a if o != op], sorted(b + [op], key=key)]
                for op in movable[:limit]]

    def exchange_candidate(self, j: int) -> list[list[int]] | None:
        """Exchange waves ``j`` and ``j+1`` wholesale — a pure reordering of
        independent schedule segments (no membership change, so caps and
        lanes are untouched); legal iff no edge crosses the boundary.  This
        is the move that works inside singleton-wave chain regions, where
        membership edits are dependency-blocked."""
        a, b = self.lists[j], self.lists[j + 1]
        nodes = self.graph.nodes
        for op in b:
            for p in nodes[op].inputs:
                if self.wave_of[p] == j:
                    return None
        return [list(b), list(a)]

    def swap_candidate(self, j: int) -> list[list[int]] | None:
        """Exchange a cross-class pair between waves ``j`` and ``j+1`` —
        the intensity-class rebalancing move."""
        a, b = self.lists[j], self.lists[j + 1]
        nodes = self.graph.nodes
        for x in a:
            if any(self.wave_of[s] == j + 1 for s in self.succ[x]):
                continue
            for y in b:
                if self.is_mem[x] == self.is_mem[y]:
                    continue
                if any(self.wave_of[p] == j for p in nodes[y].inputs):
                    continue
                da = self.wdemand[j] - self.demand[x] + self.demand[y]
                db = self.wdemand[j + 1] - self.demand[y] + self.demand[x]
                if not (self._fits_cap(da, len(a)) and self._fits_cap(db, len(b))):
                    continue
                key = self.pos.__getitem__
                return [sorted([o for o in a if o != x] + [y], key=key),
                        sorted([o for o in b if o != y] + [x], key=key)]
        return None

    def split_candidate(self, j: int) -> list[list[int]] | None:
        """Split wave ``j`` at a class boundary (or halve an over-cap wave
        that an earlier packer admitted)."""
        ops = self.lists[j]
        if len(ops) < 2:
            return None
        key = self.pos.__getitem__
        mem = sorted((o for o in ops if self.is_mem[o]), key=key)
        comp = sorted((o for o in ops if not self.is_mem[o]), key=key)
        if mem and comp:
            return [mem, comp]
        if self.wdemand[j] > self.cap:
            mid = len(ops) // 2
            both = sorted(ops, key=key)
            return [both[:mid], both[mid:]]
        return None

    def reorder_candidate(self, j: int) -> list[list[int]] | None:
        """Class-alternating re-order *within* wave ``j`` (waves unchanged —
        only the launch order the sweep sees)."""
        ops = self.lists[j]
        if len(ops) < 2:
            return None
        mixed = self._interleave(ops)
        return [mixed] if mixed != ops else None

    # -- emit ----------------------------------------------------------------
    def schedule(self) -> WaveSchedule:
        waves = [
            Wave(index=k, op_ids=list(ops),
                 fusion_groups=(self._groups[k] if self._groups[k] is not None
                                else _group(self.graph, ops)))
            for k, ops in enumerate(self.lists)
        ]
        return WaveSchedule(waves=waves)


def fusion_stats(
    sched: WaveSchedule,
    profiles: dict[int, OpProfile] | None = None,
    resource_cap: float | None = None,
) -> dict[str, float]:
    """Packing statistics; with ``profiles`` also repack-efficacy metrics.

    ``mean/max_wave_resource_util`` — per-wave summed ``resource_demand()``
    over ``resource_cap`` (how full the pool is packed; >1 on a single-op
    wave means an op that alone exceeds the cap).  ``same_class_overlap_frac``
    — fraction of ops in multi-op waves that share the wave with another op
    of their own intensity class, i.e. how often the simulator's same-class
    interference penalty fires; the repacker's complementary fill drives it
    down.
    """
    n_ops = sum(len(w.op_ids) for w in sched.waves)
    out = {
        "n_ops": float(n_ops),
        "n_waves": float(sched.n_waves),
        "n_kernels_after_fusion": float(sched.n_fused_kernels),
        "mean_wave_width": n_ops / max(sched.n_waves, 1),
        "fusion_ratio": n_ops / max(sched.n_fused_kernels, 1),
    }
    if profiles is None:
        return out
    if resource_cap is None:
        resource_cap = SimConfig().resource_cap
    utils: list[float] = []
    n_overlapped = 0
    n_in_multi = 0
    for w in sched.waves:
        utils.append(
            sum(profiles[o].cost.resource_demand() for o in w.op_ids)
            / max(resource_cap, 1e-9))
        if len(w.op_ids) < 2:
            continue
        n_in_multi += len(w.op_ids)
        per_class = {}
        for o in w.op_ids:
            c = profiles[o].intensity
            per_class[c] = per_class.get(c, 0) + 1
        n_overlapped += sum(k for k in per_class.values() if k >= 2)
    out.update(
        mean_wave_resource_util=sum(utils) / max(len(utils), 1),
        max_wave_resource_util=max(utils, default=0.0),
        same_class_overlap_frac=n_overlapped / max(n_in_multi, 1),
    )
    return out
