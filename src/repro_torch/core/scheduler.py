"""End-to-end Opara pipeline (paper Fig. 4) plus the autotune loop.

A copy of the JAX package's ``core/scheduler.py``; only
:func:`compile_plan` differs, calling this package's capturer, and
:func:`autotune` also keeps every candidate's estimate on the plan
(``SchedulePlan.candidates``) so a caller can log why it picked what it
did.

DNN model + inputs → Stream Allocator → Model Profiler → Operator Launcher
→ Wave (Re)packer → Graph Capturer → parallelized executable.

``schedule()`` is the single-policy entry point; :func:`autotune` closes the
loop on predicted makespan: it evaluates the cross-product of
{alloc policies} × {order policies} × {repack on/off} against the
simulator's fast cost model (:func:`repro_torch.core.simulator.estimate_makespan`)
and returns the min-makespan plan — the IOS insight (cost-model-guided
inter-operator schedule search) kept off the inference critical path the
Nimble way, by hiding the search behind the per-session plan cache
(:class:`repro_torch.core.Session`).

Every stage is swappable so benchmarks can mix and match (e.g. Nimble
streams + topo order = the Nimble baseline; one stream + topo order =
sequential CUDA Graph baseline).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Iterable, Mapping

from .capture import CapturedGraph, capture
from .fusion import (
    WaveEditor,
    WaveSchedule,
    build_waves,
    fusion_stats,
    regroup_waves,
    repack_waves,
)
from .graph import OpGraph
from .launch_order import ORDER_POLICIES, validate_order
from .nimble import allocate_streams_nimble
from .profiler import HardwareSpec, ModelProfiler, OpProfile, V5E, apply_profile
from .simulator import (
    SimConfig,
    SimResult,
    SweepState,
    _sweep,
    estimate_makespan,
    op_tables,
    sequential_makespan,
    simulate,
    sweep_extend,
)
from .stream_alloc import StreamPlan, allocate_streams, count_syncs


@dataclasses.dataclass
class SchedulePlan:
    """Everything the capturer / simulator needs, plus bookkeeping."""

    graph: OpGraph
    stream_plan: StreamPlan
    order: list[int]
    waves: WaveSchedule
    profiles: dict[int, OpProfile]
    alloc_policy: str
    order_policy: str
    alloc_time_ms: float
    order_time_ms: float
    # -- per-stage timing hooks (CompiledModel.explain() reads these) -------
    profile_time_ms: float = 0.0            # profiler stage (stage 2)
    wave_time_ms: float = 0.0               # wave build / repack (stage 4)
    # -- autotune / repack bookkeeping --------------------------------------
    repacked: bool = False                  # waves came from repack_waves
    sim_cfg: SimConfig | None = None        # cost-model config used, if any
    est_makespan_us: float | None = None    # winning candidate's estimate
    autotune_ms: float = 0.0                # search wall time (0 = no search)
    n_candidates: int = 1                   # schedules evaluated
    # autotune's static sweep, one (alloc, order, repacked, est µs) row per
    # candidate in evaluation order (port only: the pick is logged with it)
    candidates: tuple[tuple[str, str, bool, float], ...] = ()
    # -- iterative refinement provenance (:func:`refine`) -------------------
    refined: bool = False                   # refinement improved the plan
    refine_ms: float = 0.0                  # refinement wall time
    refine_iters: int = 0                   # accepted moves
    refine_delta_us: float = 0.0            # est improvement over the seed

    @property
    def n_streams(self) -> int:
        return self.stream_plan.n_streams

    def stats(self) -> dict[str, float]:
        cap = (self.sim_cfg or SimConfig()).resource_cap
        s = fusion_stats(self.waves, self.profiles, resource_cap=cap)
        s.update(
            n_streams=float(self.n_streams),
            n_syncs=float(count_syncs(self.graph, self.stream_plan)),
            alloc_time_ms=self.alloc_time_ms,
            order_time_ms=self.order_time_ms,
            profile_time_ms=self.profile_time_ms,
            wave_time_ms=self.wave_time_ms,
            repacked=float(self.repacked),
            autotune_ms=self.autotune_ms,
            n_candidates=float(self.n_candidates),
            refined=float(self.refined),
            refine_ms=self.refine_ms,
            refine_iters=float(self.refine_iters),
            refine_delta_us=self.refine_delta_us,
        )
        if self.est_makespan_us is not None:
            s["est_makespan_us"] = self.est_makespan_us
        return s


ALLOC_POLICIES = {
    "opara": allocate_streams,
    "nimble": allocate_streams_nimble,
    "sequential": lambda g: StreamPlan(stream_of={i: 0 for i in g.nodes}, n_streams=1),
}

# Default autotune search space.  Above the op limit the cold-path budget
# (autotune ≤ ~2× a single-policy schedule) trims the space: Nimble's
# min-path-cover allocator is O(n³), and the order list drops to the two
# strongest candidates (the caller can always pass a wider space).
AUTOTUNE_ORDER_POLICIES = ("opara", "topo", "critical_path")
AUTOTUNE_ORDER_POLICIES_LARGE = ("opara", "topo")
NIMBLE_ALLOC_OP_LIMIT = 512


def schedule(
    graph: OpGraph,
    alloc_policy: str = "opara",
    order_policy: str = "opara",
    hw: HardwareSpec = V5E,
    max_lanes: int | None = None,
    measured_inputs: Mapping[int, Any] | None = None,
    repack: bool = False,
    sim_cfg: SimConfig | None = None,
) -> SchedulePlan:
    """Run the full scheduling pipeline (no compilation).

    ``measured_inputs`` forces a fresh profiling inference (measure + hydrate
    via the profiler's apply lifecycle).  This path always re-times — use
    :meth:`repro_torch.core.Session.plan`, which consults the calibration cache
    first, when "profile once" amortization is wanted.

    ``repack=True`` swaps the launch-order wave bucketing for the resource-
    and interference-aware repacker (:func:`repro_torch.core.fusion.repack_waves`)
    under ``sim_cfg``'s resource cap; the launch order is then re-linearized
    wave-major so the dispatch sequence matches what was packed.
    """
    graph.validate()
    profiler = ModelProfiler(hw)
    if measured_inputs is not None:
        apply_profile(graph, profiler.measure(graph, measured_inputs))
    t0 = time.perf_counter()
    profiles = profiler.profile(graph)
    t_profile = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    plan = ALLOC_POLICIES[alloc_policy](graph)
    t_alloc = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    order = ORDER_POLICIES[order_policy](graph, profiles)
    t_order = (time.perf_counter() - t0) * 1e3
    validate_order(graph, order)

    if alloc_policy == "sequential":
        max_lanes = 1
    t0 = time.perf_counter()
    if repack:
        waves = repack_waves(graph, plan, order, profiles,
                             cfg=sim_cfg or SimConfig(), max_lanes=max_lanes)
        order = waves.flat_order()
        validate_order(graph, order)
    else:
        waves = build_waves(graph, plan, order, max_lanes=max_lanes)
    t_waves = (time.perf_counter() - t0) * 1e3
    return SchedulePlan(
        graph=graph,
        stream_plan=plan,
        order=order,
        waves=waves,
        profiles=profiles,
        alloc_policy=alloc_policy,
        order_policy=order_policy,
        alloc_time_ms=t_alloc,
        order_time_ms=t_order,
        profile_time_ms=t_profile,
        wave_time_ms=t_waves,
        repacked=repack,
        sim_cfg=sim_cfg,
    )


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Budget knobs for :func:`refine` (frozen + hashable — it joins the
    session plan-cache key).

    ``budget_factor`` caps the total cost-model work at ``budget_factor ×
    n_ops`` op placements — one full ``_sweep`` of the graph costs
    ``n_ops``.  A rebalance repack (see below) is pre-charged ``2 × n_ops``
    (packer work + the ranking sweep), and on graphs above
    ``REFINE_WALK_OP_LIMIT`` ops the boundary walk only starts while ``2 ×
    n_ops`` of budget remains (editor build + one full suffix pass).  The
    default of 4 therefore buys one rebalance variant plus either a second
    variant or the boundary walk — which keeps autotune+refine within the
    ~2×-single-policy-schedule cold budget on multi-thousand-op graphs;
    raise it (e.g. to 8) to walk the whole ladder.  ``min_budget`` is an
    absolute placement floor: on small graphs ``budget_factor × n_ops``
    would starve the boundary walk to save fractions of a millisecond, so
    the budget never drops below this many placements.  ``plateau`` stops the
    search after that many consecutively *rejected* candidates;
    ``max_rounds`` bounds full passes over the wave boundaries (a round
    with no accepted move also stops); ``checkpoint_stride`` is the wave
    interval between :class:`repro_torch.core.simulator.SweepState` checkpoints
    that make suffix re-estimation cheap.

    ``rebalance`` is the phase-1 ladder of repack parameterizations
    ``(cap_scale, max_lanes)`` tried before the boundary walk: the packer is
    re-run with the packing cap scaled by ``cap_scale`` (packing to e.g.
    75 % of the cap leaves headroom that trades wave width against the
    simulator's resource-cap admission stalls) and/or the wave width capped
    at ``max_lanes`` (narrower waves shrink head-of-line exposure), and each
    candidate is ranked by a full ``_sweep`` under the TRUE config — only a
    strictly better packing is adopted, so the true ``resource_cap`` always
    holds for the result.  ``max_lanes=None`` keeps the caller's lane bound.
    """

    budget_factor: float = 4.0
    min_budget: int = 8192
    plateau: int = 64
    max_rounds: int = 3
    checkpoint_stride: int = 16
    migrate_per_boundary: int = 2
    rebalance: tuple[tuple[float, int | None], ...] = (
        (0.75, None), (0.85, None), (1.0, 8))

    def __post_init__(self) -> None:
        if self.budget_factor <= 0:
            raise ValueError("budget_factor must be > 0")
        if self.min_budget < 0:
            raise ValueError("min_budget must be >= 0")
        if self.plateau < 1 or self.max_rounds < 1:
            raise ValueError("plateau and max_rounds must be >= 1")
        if self.checkpoint_stride < 1:
            raise ValueError("checkpoint_stride must be >= 1")
        if self.migrate_per_boundary < 0:
            raise ValueError("migrate_per_boundary must be >= 0")
        for scale, lanes in self.rebalance:
            if scale <= 0:
                raise ValueError("rebalance cap_scale must be > 0")
            if lanes is not None and lanes < 1:
                raise ValueError("rebalance max_lanes must be >= 1 or None")


def _normalize_refine(refine: "bool | RefineConfig | None") -> RefineConfig | None:
    """``False``/``None`` → off, ``True`` → defaults (so ``refine=True`` and
    an explicit default config share plan-cache entries)."""
    if refine is None or refine is False:
        return None
    if refine is True:
        return RefineConfig()
    if isinstance(refine, RefineConfig):
        return refine
    raise TypeError(f"refine must be bool or RefineConfig, got {refine!r}")


# accepted move must beat the incumbent by more than float noise
_REFINE_EPS = 1e-9

# above this size the boundary walk runs only on leftover budget (the
# rebalance ladder is the productive phase on huge graphs; see RefineConfig)
REFINE_WALK_OP_LIMIT = 1024


def refine(
    plan: SchedulePlan,
    cfg: SimConfig | None = None,
    refine_cfg: "bool | RefineConfig | None" = None,
    max_lanes: int | None = None,
) -> SchedulePlan:
    """IOS-style iterative schedule refinement under the ``_sweep`` oracle.

    Starts from ``plan`` (typically the :func:`autotune` winner) and
    searches in two phases, accepting a candidate only when its predicted
    makespan is *strictly* better:

    1. **Rebalance** — re-runs the wave packer under the perturbed
       parameterizations of ``RefineConfig.rebalance`` (scaled packing cap,
       bounded lane width) and ranks each candidate packing by a full
       ``_sweep`` under the true config.  This is the move that pays on
       multi-thousand-op graphs, where the static sweep's single packing
       sits at a strong local optimum of the boundary-move neighborhood.
    2. **Boundary walk** — walks the wave boundaries of the incumbent
       proposing local edits: merge / split of adjacent waves, op migration
       across a boundary respecting dependencies and ``resource_cap``,
       whole-wave exchanges, cross-class swaps and in-wave class
       re-interleaving (intensity rebalancing).  Boundaries are visited
       back-to-front so each candidate re-estimates only the schedule
       suffix behind the edit, resumed from the nearest
       :class:`SweepState` checkpoint (delta re-estimation with a shared
       per-op end array — ``SweepState.fork``).

    See :class:`RefineConfig` for the budget / plateau semantics that bound
    the cold cost.

    Returns a new :class:`SchedulePlan` (``refined=True`` provenance, waves
    re-emitted with fusion groups recomputed for edited waves only) — or the
    input plan with refinement bookkeeping attached when no candidate beat
    the seed.  The result is never worse than the seed: the launch order is
    only replaced when its predicted makespan strictly improves on the
    seed's.
    """
    rcfg = _normalize_refine(refine_cfg) or RefineConfig()
    cfg = cfg or plan.sim_cfg or SimConfig()
    t0 = time.perf_counter()
    graph = plan.graph
    n = len(graph.nodes)
    tables = op_tables(graph, plan.stream_plan, plan.profiles)

    seed_est = (plan.est_makespan_us if plan.est_makespan_us is not None
                and plan.sim_cfg == cfg else _sweep(tables, plan.order, cfg))
    default_lanes = (max_lanes if max_lanes is not None
                     else max(plan.n_streams, 1))

    budget = max(rcfg.budget_factor * n, rcfg.min_budget)
    swept = 0
    evals = 0
    accepted = 0
    stride = rcfg.checkpoint_stride

    # incumbent: the seed waves' own linearization (for non-repacked seeds
    # this can differ from plan.order — adoption is still gated on beating
    # seed_est below, so the result is never worse than the seed)
    seed_flat = [op for w in plan.waves.waves for op in w.op_ids]
    if seed_flat == plan.order:
        current = seed_est
    else:
        current = _sweep(tables, seed_flat, cfg)
        swept += n
        evals += 1
    best_final = current

    # -- phase 1: rebalance — repack under perturbed knobs, rank under the
    # true config, adopt the best strictly-better packing as the incumbent
    best_var: tuple[float, WaveSchedule] | None = None
    for scale, lanes in rcfg.rebalance:
        if swept + 2 * n >= budget:     # pre-charge: a variant costs 2n
            break
        scaled = scale != 1.0 and not math.isinf(cfg.resource_cap)
        lanes_eff = default_lanes if lanes is None else min(lanes, default_lanes)
        if not scaled and lanes_eff == default_lanes:
            continue            # identical knobs to the seed packer
        pack_cfg = (dataclasses.replace(
            cfg, resource_cap=cfg.resource_cap * scale) if scaled else cfg)
        ws = repack_waves(graph, plan.stream_plan, plan.order, plan.profiles,
                          cfg=pack_cfg, max_lanes=lanes_eff, group=False)
        swept += 2 * n          # packer work + the ranking sweep below
        evals += 1
        var_est = _sweep(tables, ws.flat_order(), cfg)
        if var_est < current - _REFINE_EPS and (
                best_var is None or var_est < best_var[0]):
            best_var = (var_est, ws)
    waves_in = plan.waves
    if best_var is not None:
        current = best_final = best_var[0]
        waves_in = regroup_waves(graph, best_var[1])
        swept += n              # the regroup pass
        accepted += 1

    # -- phase 2: boundary walk — built lazily, and on large graphs only
    # while enough budget remains for the editor's dense indices plus one
    # full suffix pass (below the op limit both are sub-millisecond, so the
    # walk always runs and the placement budget alone bounds it)
    editor: WaveEditor | None = None
    if n <= REFINE_WALK_OP_LIMIT or swept + 2 * n <= budget:
        editor = WaveEditor(graph, waves_in, plan.profiles, cfg=cfg,
                            max_lanes=default_lanes)
        # checkpoints[i] = (wave index k, SweepState after waves[:k]); entry
        # 0 is the empty state, later entries are recorded lazily while
        # sweeping
        checkpoints: list[tuple[int, SweepState]] = [(0, SweepState(n))]

        def eval_from(j: int, replacement: list[list[int]],
                      n_replaced: int) -> float:
            """Predicted makespan of the schedule with
            ``lists[j:j+n_replaced]`` replaced — sweeps only from the
            nearest checkpoint ≤ j."""
            nonlocal swept
            ci = max(i for i, (k, _) in enumerate(checkpoints) if k <= j)
            k, st = checkpoints[ci]
            # fork, not clone: all states share one per-op end array (see
            # SweepState.fork — entries behind the fork point are rewritten
            # before any read), so an eval costs O(prefix-from-checkpoint +
            # suffix) with no O(n) copy
            st = st.fork()
            lists = editor.lists
            while k < j:    # unmodified prefix: re-record checkpoint density
                sweep_extend(tables, lists[k], cfg, st)
                swept += len(lists[k])
                k += 1
                if k % stride == 0 and k > checkpoints[-1][0] and k < j:
                    checkpoints.append((k, st.fork()))
            suffix: list[int] = [op for w in replacement for op in w]
            for w in lists[j + n_replaced:]:
                suffix.extend(w)
            sweep_extend(tables, suffix, cfg, st)
            swept += len(suffix)
            return st.makespan

        rejects_in_row = 0
        stopped = False
        for _round in range(rcfg.max_rounds):
            accepted_this_round = 0
            j = editor.n_waves - 1
            while j >= 0 and not stopped:
                if swept >= budget:
                    stopped = True
                    break
                cands: list[tuple[int, list[list[int]]]] = []
                if j + 1 < editor.n_waves:
                    merged = editor.merge_candidate(j)
                    if merged is not None:
                        cands.append((2, merged))
                    cands += [(2, c) for c in editor.migrate_candidates(
                        j, rcfg.migrate_per_boundary)]
                    cands += [(2, c) for c in editor.push_candidates(j)]
                    swapped = editor.swap_candidate(j)
                    if swapped is not None:
                        cands.append((2, swapped))
                    exchanged = editor.exchange_candidate(j)
                    if exchanged is not None:
                        cands.append((2, exchanged))
                split = editor.split_candidate(j)
                if split is not None:
                    cands.append((1, split))
                reordered = editor.reorder_candidate(j)
                if reordered is not None:
                    cands.append((1, reordered))
                accepted_here = False
                for n_replaced, replacement in cands:
                    est = eval_from(j, replacement, n_replaced)
                    evals += 1
                    if est < current - _REFINE_EPS:
                        editor.apply(j, n_replaced, replacement)
                        while checkpoints[-1][0] > j:  # suffix states stale
                            checkpoints.pop()
                        current = est
                        best_final = est
                        accepted += 1
                        accepted_this_round += 1
                        rejects_in_row = 0
                        # sibling proposals were built against the
                        # pre-accept waves — regenerate at this boundary
                        accepted_here = True
                        break
                    rejects_in_row += 1
                    if rejects_in_row >= rcfg.plateau:
                        stopped = True
                        break
                    if swept >= budget:
                        stopped = True
                        break
                if not accepted_here:
                    j -= 1
            if stopped or accepted_this_round == 0:
                break

    refine_ms = (time.perf_counter() - t0) * 1e3
    n_candidates = plan.n_candidates + evals
    if accepted == 0 or best_final >= seed_est - _REFINE_EPS:
        # nothing beat the seed: keep its schedule, attach the bookkeeping
        return dataclasses.replace(
            plan, sim_cfg=cfg, est_makespan_us=seed_est, refined=False,
            refine_ms=refine_ms, refine_iters=0, n_candidates=n_candidates)
    if editor is not None and editor.n_edits > 0:
        waves = editor.schedule()
    else:
        waves = waves_in            # ladder winner, already regrouped
    order = waves.flat_order()
    validate_order(graph, order)
    return dataclasses.replace(
        plan, order=order, waves=waves, sim_cfg=cfg,
        est_makespan_us=best_final, refined=True, refine_ms=refine_ms,
        refine_iters=accepted, refine_delta_us=seed_est - best_final,
        n_candidates=n_candidates)


# autotune's ``refine`` parameter shadows the function; alias it for the call
_refine_plan = refine


def autotune(
    graph: OpGraph,
    hw: HardwareSpec = V5E,
    cfg: SimConfig | None = None,
    alloc_policies: Iterable[str] | None = None,
    order_policies: Iterable[str] | None = None,
    repack_options: Iterable[bool] = (False, True),
    max_lanes: int | None = None,
    measured_inputs: Mapping[int, Any] | None = None,
    refine: "bool | RefineConfig" = False,
) -> SchedulePlan:
    """Simulator-guided schedule search: pick the min-predicted-makespan
    plan from {alloc} × {order} × {repack on/off}.

    Work is shared across candidates — the graph is profiled once, each
    allocator and each order run once — so the search costs one pipeline
    pass plus a wave-build + cost-model sweep per candidate.  The result is
    an ordinary :class:`SchedulePlan` (with ``est_makespan_us`` /
    ``autotune_ms`` / ``n_candidates`` filled in), cacheable under the plan
    cache exactly like a single-policy schedule.

    ``refine`` (``True`` or a :class:`RefineConfig`) hands the static-sweep
    winner to :func:`refine` for iterative local search — the IOS move —
    with its wall time folded into ``autotune_ms`` and surfaced separately
    as ``refine_ms``.
    """
    graph.validate()
    cfg = cfg or SimConfig()
    repack_options = tuple(repack_options)   # membership-tested twice below
    profiler = ModelProfiler(hw)
    if measured_inputs is not None:
        apply_profile(graph, profiler.measure(graph, measured_inputs))
    t_search0 = time.perf_counter()
    profiles = profiler.profile(graph)
    t_profile = (time.perf_counter() - t_search0) * 1e3

    small = len(graph) <= NIMBLE_ALLOC_OP_LIMIT
    if alloc_policies is None:
        alloc_policies = ("opara", "nimble") if small else ("opara",)
    if order_policies is None:
        order_policies = (AUTOTUNE_ORDER_POLICIES if small
                          else AUTOTUNE_ORDER_POLICIES_LARGE)

    allocs: dict[str, tuple[StreamPlan, float]] = {}
    for ap in alloc_policies:
        t0 = time.perf_counter()
        allocs[ap] = (ALLOC_POLICIES[ap](graph),
                      (time.perf_counter() - t0) * 1e3)
    orders: dict[str, tuple[list[int], float]] = {}
    for op_ in order_policies:
        t0 = time.perf_counter()
        order = ORDER_POLICIES[op_](graph, profiles)
        orders[op_] = (order, (time.perf_counter() - t0) * 1e3)
        validate_order(graph, order)

    # Evaluate candidates on (streams, order) alone — the cost model never
    # reads waves, so the wave build (the costliest per-candidate step) is
    # deferred to the single winner.  Repacked candidates are the exception:
    # repacking IS a wave build, and its flat order is what gets estimated —
    # every order is repacked and ranked on its own flat order, so the
    # order×repack interaction is explored on large graphs too (repacking
    # only the plain-sweep winner left e.g. bert-180L at ``repacked: false``
    # whenever a repacked non-winner order would have beaten it).
    best: tuple[float, str, str, bool, Any, list[int], WaveSchedule | None] | None = None
    n_candidates = 0
    candidates: list[tuple[str, str, bool, float]] = []

    def consider(est, ap, op_, rp, splan, cand_order, waves) -> None:
        nonlocal best, n_candidates
        n_candidates += 1
        candidates.append((ap, op_, rp, est))
        if best is None or est < best[0]:
            best = (est, ap, op_, rp, splan, cand_order, waves)

    for ap, (splan, t_alloc) in allocs.items():
        tables = op_tables(graph, splan, profiles)   # one prefetch per alloc
        if False in repack_options:
            for op_, (order, t_order) in orders.items():
                est = _sweep(tables, order, cfg)
                consider(est, ap, op_, False, splan, order, None)
        if True in repack_options:
            for op_ in orders:
                order = orders[op_][0]
                # group=False: candidates are ranked on flat_order() alone,
                # so fusion grouping is deferred to the single winner below
                waves = repack_waves(graph, splan, order, profiles,
                                     cfg=cfg, max_lanes=max_lanes,
                                     group=False)
                cand_order: list[int] = waves.flat_order()
                est = _sweep(tables, cand_order, cfg)
                consider(est, ap, op_, True, splan, cand_order, waves)
    assert best is not None, "autotune needs a non-empty candidate space"
    est, ap, op_, rp, splan, cand_order, waves = best
    t0 = time.perf_counter()
    if waves is None:
        waves = build_waves(graph, splan, cand_order, max_lanes=max_lanes)
    else:
        waves = regroup_waves(graph, waves)
    t_waves = (time.perf_counter() - t0) * 1e3
    plan = SchedulePlan(
        graph=graph, stream_plan=splan, order=cand_order, waves=waves,
        profiles=profiles, alloc_policy=ap, order_policy=op_,
        alloc_time_ms=allocs[ap][1], order_time_ms=orders[op_][1],
        profile_time_ms=t_profile, wave_time_ms=t_waves,
        repacked=rp, sim_cfg=cfg, est_makespan_us=est,
        autotune_ms=(time.perf_counter() - t_search0) * 1e3,
        n_candidates=n_candidates, candidates=tuple(candidates))
    rcfg = _normalize_refine(refine)
    if rcfg is not None:
        plan = _refine_plan(plan, cfg=cfg, refine_cfg=rcfg,
                            max_lanes=max_lanes)
        plan = dataclasses.replace(
            plan, autotune_ms=(time.perf_counter() - t_search0) * 1e3)
    return plan


def compile_plan(plan: SchedulePlan, output_ids=None,
                 gemm_kernel: str = "auto", faults=None) -> CapturedGraph:
    return capture(plan.graph, plan.waves, output_ids=output_ids,
                   gemm_kernel=gemm_kernel, faults=faults,
                   stream_plan=plan.stream_plan)


def simulate_plan(plan: SchedulePlan, cfg: SimConfig | None = None) -> SimResult:
    return simulate(plan.graph, plan.stream_plan, plan.order, plan.profiles,
                    cfg or SimConfig())


def estimate_plan(plan: SchedulePlan, cfg: SimConfig | None = None) -> float:
    """Cost-model makespan of an existing plan (the autotuner's objective)."""
    return estimate_makespan(plan.graph, plan.stream_plan, plan.order,
                             plan.profiles, cfg or SimConfig())


def compare_policies(
    graph: OpGraph,
    hw: HardwareSpec = V5E,
    cfg: SimConfig | None = None,
    opara_plan: SchedulePlan | None = None,
    tuned_meta: dict[str, str] | None = None,
) -> dict[str, dict[str, float]]:
    """The paper's four-way comparison on one graph (Fig. 5a analogue).

    The ``opara`` row is the full closed-loop pipeline — autotuned over
    {alloc} × {order} × {repack} — simulated under the same config as the
    baselines.  Callers that already ran the search (e.g. benchmarks also
    reporting the tuned plan's packing stats) pass it as ``opara_plan`` so
    it is not repeated.  Returns {policy: {makespan_us, ...}} — numeric
    metrics only; the tuned plan's *string* provenance (picked alloc/order
    policies) goes into ``tuned_meta`` if the caller passes a dict for it,
    keeping the rows honestly ``dict[str, float]``.
    """
    cfg = cfg or SimConfig()
    results: dict[str, dict[str, float]] = {}
    seq_plan = schedule(graph, "sequential", "topo", hw)
    t_seq_nograph = sequential_makespan(
        graph, seq_plan.profiles, dataclasses.replace(cfg, graph_capture=False)
    )
    t_seq = sequential_makespan(graph, seq_plan.profiles, cfg)
    results["pytorch_eager"] = {"makespan_us": t_seq_nograph, "speedup_vs_eager": 1.0}
    results["cuda_graph_sequential"] = {
        "makespan_us": t_seq,
        "speedup_vs_eager": t_seq_nograph / t_seq,
    }
    plans = {
        "nimble": schedule(graph, "nimble", "topo", hw),
        "opara": opara_plan if opara_plan is not None
        else autotune(graph, hw=hw, cfg=cfg),
    }
    for name, p in plans.items():
        r = simulate(graph, p.stream_plan, p.order, p.profiles, cfg)
        results[name] = {
            "makespan_us": r.makespan_us,
            "speedup_vs_eager": t_seq_nograph / r.makespan_us,
            "speedup_vs_cuda_graph": t_seq / r.makespan_us,
            "n_streams": float(p.n_streams),
            "n_syncs": float(r.n_syncs),
            "utilization": r.utilization(max(p.n_streams, 1)),
        }
        if name == "opara":
            results[name].update(
                repacked=float(p.repacked),
                n_candidates=float(p.n_candidates),
                est_makespan_us=float(p.est_makespan_us or 0.0),
                refined=float(p.refined),
                refine_iters=float(p.refine_iters),
                refine_delta_us=float(p.refine_delta_us),
            )
            if tuned_meta is not None:
                tuned_meta["tuned_alloc"] = p.alloc_policy
                tuned_meta["tuned_order"] = p.order_policy
    return results
