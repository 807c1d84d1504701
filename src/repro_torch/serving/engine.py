"""Continuous-batching inference engine with an overload-robust admission tier.

The port of the JAX package's ``serving/engine.py``: a fixed pool of decode
slots sharing one stacked cache (a dense KV slab, fixed KV pages behind
block tables with ``paged_kv=True``, or, for RWKV and Hymba, recurrent
state per slot (beside Hymba's KV slab), where ``paged_kv=True`` degrades
to the dense layout as in the JAX package);
one engine tick is either one prefill
or one batched decode step; per-request sampling; EOS / max-token
completion; the admission tier of :mod:`.admission` (bounded EDF queue,
load shedding, deadline expiry, priority preemption) on a deterministic
tick clock; every decision recorded in ``fault_stats`` and on
``Request.error``.  ``run()`` takes every submitted request to a terminal
state.

Where the JAX package jits the decode step once per model, the port records
it once per engine as a ``torch.cuda.CUDAGraph`` (the capturer's
:class:`~repro_torch.core.capture.CudaGraphReplay`), at the first decode
tick: static token / position (/ block-table) buffers are copied into
before each replay, and the step writes the caches in place, so every cache
update outside the step (splice, page scatter, page copy) is in place too;
the step's one warm-up run before recording writes the same K/V as the
replay that follows.  The ladder keeps its rungs: a failing graph step latches
the eager step (the same kernels, launched one by one) with a probation
retry; a failing paged step falls to the dense-gather rung.  On the CPU
there is no graph: the "compiled" rung is the eager step, and the
``decode_step`` fault still fires on it, so fault counters compare with the
JAX package's.

The ``REPRO_*`` flags (:mod:`repro_torch.flags`) are read when the step
runs, so the recorded graph keeps the values of its first decode tick:
set them before the engine serves.  Under ``kv_quant`` an MLA model's
``paged_kv=True`` degrades to the dense slab as in the JAX package, and
the dense slab's first admission raises, as there (ROADMAP C19): the
prefill's bf16 latent does not fit the int8 triple, and the splice checks
every leaf before it writes one.

The engine's device is its params' device.  Sampling runs there: greedy is
``argmax``; temperature / top-k / top-p draw from the engine's
``torch.Generator`` (seeded from ``seed``), so sampled streams differ from
the JAX package's while greedy streams match.
"""
from __future__ import annotations

import copy
import warnings
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.capture import CudaGraphReplay
from ..flags import kv_quant
from ..models import Model
from ..runtime.faults import FaultInjected, FaultPlan
from ..runtime.faults import get_active as _active_faults
from ..runtime.guard import DegradationWarning
from .admission import (AdmissionConfig, AdmissionQueue, Request,
                        RequestState, TERMINAL_STATES, deadline_critical)
from .kv_pool import (KVPagePool, KVPoolConfig, PageExhausted,
                      page_content_keys)
from .sampler import sample_token

__all__ = ["InferenceEngine", "Request", "RequestState", "AdmissionConfig",
           "TERMINAL_STATES"]


def _empty_tenant_stats() -> dict[str, int]:
    return {"submitted": 0, "done": 0, "failed": 0, "shed": 0,
            "expired": 0, "preempted": 0}


class InferenceEngine:
    def __init__(self, model: Model, params, max_slots: int = 4,
                 max_len: int = 512, seed: int = 0, calibrate: bool = False,
                 session=None, fault_plan: FaultPlan | None = None,
                 admission: AdmissionConfig | None = None,
                 watchdog_probation: int = 8,
                 tenant_sessions: Mapping[str, Any] | None = None,
                 paged_kv: bool = False, page_size: int = 16,
                 num_pages: int | None = None, prefix_sharing: bool = False,
                 page_bounce_limit: int = 8):
        self.model = model
        self.params = params
        self.device: torch.device = params["embed"]["table"].device
        # repro_torch.core.Session owning this engine's schedule/calibration
        # state (None → the process-wide default session)
        self.session = session
        # per-tenant Sessions: shed/expire/preempt events for a tenant's
        # requests are noted on that tenant's guard_log
        self.tenant_sessions = dict(tenant_sessions or {})
        # per-engine injection plan (None → $REPRO_FAULT_PLAN, if armed)
        self.fault_plan = fault_plan
        # watchdog latch: once the graph step fails, ticks run the eager
        # step; after ``watchdog_probation`` clean eager ticks the graph
        # step is retried once (0 disables probation)
        self._use_compiled = True
        self.watchdog_probation = watchdog_probation
        self._eager_clean_ticks = 0
        self.fault_stats = {"decode_faults": 0, "failed_requests": 0,
                            "watchdog_fallbacks": 0, "watchdog_probations": 0,
                            "shed_requests": 0, "expired_requests": 0,
                            "preemptions": 0, "admission_faults": 0,
                            "preempt_faults": 0, "deadline_faults": 0,
                            "page_exhaustions": 0, "page_alloc_faults": 0,
                            "block_table_faults": 0, "page_release_faults": 0,
                            "paged_decode_fallbacks": 0, "page_resumes": 0,
                            "resumed_tokens": 0, "reprefilled_tokens": 0,
                            "by_tenant": {}}
        self.cfg: ModelConfig = model.cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # deterministic tick clock: one step() == one tick
        self.tick = 0
        self.admission_cfg = admission if admission is not None \
            else AdmissionConfig()
        self.admission = AdmissionQueue(self.admission_cfg)
        self.accepting = True            # drain() closes admission
        self._terminal: list[Request] = []   # terminal before reaching a slot
        self.slots: list[Request | None] = [None] * max_slots
        self.pos = np.zeros(max_slots, np.int32)
        self.last_token = np.zeros(max_slots, np.int32)
        # paged KV tier: fixed pages + block tables instead of a dense slab;
        # an unsupported model degrades to the dense slab with provenance
        self.paged = False
        self.prefix_sharing = prefix_sharing
        self.page_bounce_limit = page_bounce_limit
        self.pool: KVPagePool | None = None
        if paged_kv:
            reason = None
            if not model.supports_paged():
                reason = (f"family {self.cfg.family!r} carries recurrent or "
                          "cross-attention state; paged KV needs a "
                          "pure-attention decoder stack")
            elif kv_quant() and self.cfg.mla is not None:
                reason = ("kv_quant int8 latent cache is dense-only; "
                          "paged MLA pages the bf16 latent")
            if reason is not None:
                warnings.warn(f"paged_kv unavailable: {reason}; "
                              "using the dense slab cache",
                              DegradationWarning, stacklevel=2)
                if self.session is not None:
                    self.session.note_degradation(
                        "paged_kv", "paged->dense", reason, warn=False)
            else:
                self.paged = True
        cache_len = max_len + self.cfg.meta_tokens
        if self.paged:
            self._pages_per_req = -(-cache_len // page_size)
            if num_pages is None:
                # null page + a full allocation per slot (capacity parity
                # with the dense slab; pass a smaller pool to overcommit)
                num_pages = 1 + max_slots * self._pages_per_req
            self.pool = KVPagePool(KVPoolConfig(num_pages, page_size))
            self.caches = model.init_paged_caches(num_pages, page_size,
                                                  self.device)
            self._page_bounces: dict[str, int] = {}
        else:
            from ..models.transformer import init_decode_caches
            self.caches = init_decode_caches(self.cfg, max_slots, cache_len,
                                             device=self.device)
        # the recurrent leaves (RWKV's state, a hybrid stack's Mamba state),
        # which every step advances in place
        self._state_leaves = _state_leaves(self.caches)
        self.decode_graph: CudaGraphReplay | None = None
        self._step = self._make_step()
        # Measured-mode Opara schedule of this engine's step graph, filled by
        # calibrate_schedule()
        self.schedule_plan = None
        if calibrate:
            self.calibrate_schedule()

    @property
    def queue(self) -> list[Request]:
        """Read-only view of the queued (PENDING) requests, in arrival
        order."""
        return list(self.admission)

    # -- the decode step -----------------------------------------------------------
    def _make_step(self) -> Callable[[list[np.ndarray]], torch.Tensor]:
        """The "compiled" rung: one CUDA graph of the decode step on the
        card (recorded at its first call), the eager step on the CPU."""
        if self.paged:
            def step(token, pos, bt):
                return self.model.paged_decode(self.params, token, self.caches,
                                               bt, pos)[0]
            dtypes = [torch.long, torch.int32, torch.int32]
        else:
            def step(token, pos):
                return self.model.decode(self.params, token, self.caches,
                                         pos)[0]
            dtypes = [torch.long, torch.int32]

        def run(values: list[np.ndarray]) -> torch.Tensor:
            args = [self._on_device(v, d) for v, d in zip(values, dtypes)]
            if self.device.type != "cuda":
                return step(*args)
            if self.decode_graph is None:
                self.decode_graph = CudaGraphReplay(lambda *a: [step(*a)],
                                                    args)
            return self.decode_graph(args)[0]
        return run

    def _on_device(self, value: np.ndarray,
                   dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(value)).to(
            device=self.device, dtype=dtype)

    def _eager_decode(self):
        """The eager rung: the model's decode step, kernel by kernel."""
        return self.model.decode(
            self.params, self._on_device(self.last_token, torch.long),
            self.caches, self._on_device(self.pos, torch.int32))[0]

    def calibrate_schedule(self, seq: int = 1, n_layers: int | None = None,
                           repeats: int = 1):
        """(Re-)schedule this engine's step graph with measured timings.

        Exports the model's operator DAG at this engine's decode geometry
        (batch = ``max_slots``; MoE models with the routed fan-out, RWKV
        with its scan, Hymba with its Mamba branch) with the port's
        exporter, binds zero tokens as profiling inputs, and plans through
        this engine's :class:`repro_torch.core.Session` — so the one
        profiling inference is shared by every engine with the same
        signature.  The plan is
        introspection state; the decode hot path is the step above."""
        from ..core.session import default_session
        from ..models.opgraph_export import build_lm_opgraph

        sess = self.session if self.session is not None else default_session()
        g = build_lm_opgraph(self.cfg, batch=self.max_slots, seq=seq,
                             params=self.params, n_layers=n_layers)
        unbindable = [n.name for n in g
                      if n.fn is None and n.out_shape is None]
        if unbindable:
            sess.note_degradation(
                "calibration_measure", "measured->analytic",
                f"{self.cfg.name!r} exports {len(unbindable)} cost-only "
                f"operators without payloads (e.g. {unbindable[0]!r}); "
                "scheduling on analytic costs")
            self.schedule_plan = sess.plan(g)
            return self.schedule_plan
        inputs = {n.op_id: torch.zeros(n.out_shape, dtype=torch.long,
                                       device=self.device)
                  for n in g if n.fn is None}
        sess.calibrate(g, inputs, repeats=repeats)
        self.schedule_plan = sess.plan(g)
        return self.schedule_plan

    # -- faults / provenance plumbing ---------------------------------------------
    def _faults(self) -> FaultPlan | None:
        return (self.fault_plan if self.fault_plan is not None
                else _active_faults())

    def _tenant_stats(self, tenant: str) -> dict[str, int]:
        stats = self.fault_stats["by_tenant"].get(tenant)
        if stats is None:
            stats = self.fault_stats["by_tenant"][tenant] = \
                _empty_tenant_stats()
        return stats

    def _tenant_note(self, req: Request, site: str, action: str,
                     reason: str) -> None:
        sess = self.tenant_sessions.get(req.tenant)
        if sess is not None:
            sess.note_degradation(site, action, reason, warn=False)

    # -- terminal transitions -----------------------------------------------------
    def _fail(self, req: Request, reason: str) -> Request:
        """Terminal eviction of ONE poisoned request; co-batched requests
        are untouched."""
        req.state = RequestState.FAILED
        req.error = reason
        req.finish_tick = self.tick
        self.fault_stats["failed_requests"] += 1
        self._tenant_stats(req.tenant)["failed"] += 1
        self._release_pages(req)
        return req

    def _shed(self, req: Request, reason: str) -> Request:
        req.state = RequestState.SHED
        req.error = reason
        req.finish_tick = self.tick
        self.fault_stats["shed_requests"] += 1
        self._tenant_stats(req.tenant)["shed"] += 1
        self._tenant_note(req, "admission_enqueue", "admit->shed", reason)
        self._release_pages(req)
        return req

    def _expire(self, req: Request, reason: str) -> Request:
        req.state = RequestState.EXPIRED
        req.error = reason
        req.finish_tick = self.tick
        self.fault_stats["expired_requests"] += 1
        self._tenant_stats(req.tenant)["expired"] += 1
        self._tenant_note(req, "deadline_check", "request->expired", reason)
        self._release_pages(req)
        return req

    def _complete(self, req: Request) -> Request:
        req.state = RequestState.DONE
        req.finish_tick = self.tick
        self._tenant_stats(req.tenant)["done"] += 1
        self._release_pages(req)
        return req

    def _release_pages(self, req: Request) -> None:
        """Free ``req``'s KV pages on any terminal transition (preemption is
        not terminal).  An injected ``page_release`` fault leaks the pages
        (counted) instead of corrupting the free list."""
        if not self.paged or not self.pool.holds(req.rid):
            return
        faults = self._faults()
        if faults is not None:
            try:
                faults.fire("page_release")
            except FaultInjected as exc:
                self.fault_stats["page_release_faults"] += 1
                n = self.pool.leak(req.rid)
                reason = f"{exc}: {n} pages leaked"
                self._tenant_note(req, "page_release", "release->leaked", reason)
                if self.session is not None:
                    self.session.note_degradation(
                        "page_release", "release->leaked", reason, warn=False)
                self._page_bounces.pop(req.rid, None)
                return
        self.pool.release(req.rid)
        self._page_bounces.pop(req.rid, None)

    def _clear_slot(self, slot: int) -> None:
        self.slots[slot] = None
        self.pos[slot] = 0
        self.last_token[slot] = 0

    # -- API ---------------------------------------------------------------------
    def submit(self, req: Request) -> Request:
        """Offer ``req`` to the admission tier (it may go terminal at once:
        SHED, or FAILED for a prompt beyond the KV capacity)."""
        if req.submit_tick < 0:
            req.submit_tick = self.tick
        if req.deadline is None and req.ttl is not None:
            req.deadline = req.submit_tick + req.ttl
        self._tenant_stats(req.tenant)["submitted"] += 1
        if not self.accepting:
            self._terminal.append(
                self._shed(req, "engine draining: admission closed"))
            return req
        faults = self._faults()
        if faults is not None:
            try:
                faults.fire("admission_enqueue")
            except FaultInjected as exc:
                self.fault_stats["admission_faults"] += 1
                self._terminal.append(self._shed(req, f"{exc}"))
                return req
        n_tokens = len(req.prompt) + len(req.output)
        if n_tokens >= self.max_len:
            self._terminal.append(self._fail(req, (
                f"prompt length {n_tokens} exceeds KV capacity "
                f"(max_len={self.max_len} incl. at least one decode "
                "position); rejected at admission")))
            return req
        admitted, shed, reason = self.admission.offer(req, self.tick)
        for victim in shed:
            self._terminal.append(self._shed(victim, reason))
        return req

    def run(self, max_ticks: int = 1000) -> list[Request]:
        """Tick until all work is terminal or ``max_ticks`` is exhausted;
        leftovers are expired, never stranded."""
        done: list[Request] = []
        for _ in range(max_ticks):
            if not self._work_pending():
                break
            done.extend(self.step())
        done.extend(self._drain_terminal())
        leftovers = self.admission.clear()
        for i, req in enumerate(self.slots):
            if req is not None:
                leftovers.append(req)
                self._clear_slot(i)
        for req in leftovers:
            done.append(self._expire(req, "tick budget exhausted"))
        return done

    def drain(self, max_ticks: int = 1000) -> list[Request]:
        """Close admission and finish in-flight work."""
        self.accepting = False
        return self.run(max_ticks)

    def health(self) -> dict[str, Any]:
        running = sum(1 for s in self.slots if s is not None)
        return {
            "tick": self.tick,
            "accepting": self.accepting,
            "queued": len(self.admission),
            "queued_by_tenant": self.admission.depth_by_tenant(),
            "running": running,
            "free_slots": self.max_slots - running,
            "compiled_decode": self._use_compiled,
            "paged": self.pool.health() if self.paged else None,
            "kv_cache_bytes": self.kv_cache_bytes(),
            "fault_stats": copy.deepcopy(self.fault_stats),
        }

    def kv_cache_bytes(self) -> int:
        """Total bytes held by the cache (dense slab, page pool, or
        recurrent state)."""
        return sum(t.numel() * t.element_size() for t in _leaves(self.caches))

    # -- one tick -----------------------------------------------------------------
    def step(self) -> list[Request]:
        self.tick += 1
        out = self._drain_terminal()
        out.extend(self._deadline_sweep())
        free = [i for i, s in enumerate(self.slots) if s is None]
        if free and len(self.admission):
            req = self.admission.pop_next()
            out.extend(self._admit(free[0], req))
            return out
        if not free and len(self.admission) and self.admission_cfg.preemption:
            out.extend(self._maybe_preempt())
        out.extend(self._paged_decode_tick() if self.paged
                   else self._decode_tick())
        return out

    def _work_pending(self) -> bool:
        return bool(len(self.admission) or self._terminal
                    or any(s is not None for s in self.slots))

    def _drain_terminal(self) -> list[Request]:
        out, self._terminal = self._terminal, []
        return out

    def _deadline_sweep(self) -> list[Request]:
        """Expire queued requests that can no longer meet their deadline
        and evict running requests whose deadline has passed."""
        out: list[Request] = []
        faults = self._faults()
        if faults is not None:
            try:
                faults.fire("deadline_check")
            except FaultInjected:
                self.fault_stats["deadline_faults"] += 1
                return out
        for req, reason in self.admission.expire(self.tick):
            out.append(self._expire(req, reason))
        if self.admission_cfg.expire_running:
            for i, req in enumerate(self.slots):
                if req is None or req.deadline is None:
                    continue
                if self.tick > req.deadline:
                    self._clear_slot(i)
                    out.append(self._expire(req, (
                        f"deadline {req.deadline} passed at tick "
                        f"{self.tick} with {len(req.output)} tokens "
                        "generated; slot evicted")))
        return out

    def _maybe_preempt(self) -> list[Request]:
        """Evict the least-important running request when the most urgent
        queued one is deadline-critical and strictly higher priority; the
        victim returns to the queue PENDING with its output."""
        cand = self.admission.peek()
        if cand is None or not deadline_critical(cand, self.tick):
            return []
        running = [(i, req) for i, req in enumerate(self.slots)
                   if req is not None]
        if not running:
            return []
        slot, victim = min(
            running,
            key=lambda it: (it[1].priority,
                            -(float("inf") if it[1].deadline is None
                              else float(it[1].deadline)), it[0]))
        if victim.priority >= cand.priority:
            return []
        faults = self._faults()
        if faults is not None:
            try:
                faults.fire("slot_preempt")
            except FaultInjected:
                self.fault_stats["preempt_faults"] += 1
                return []
        self._clear_slot(slot)
        victim.state = RequestState.PENDING
        victim.preemptions += 1
        self.fault_stats["preemptions"] += 1
        self._tenant_stats(victim.tenant)["preempted"] += 1
        reason = (f"slot {slot} preempted at tick {self.tick} for "
                  f"rid={cand.rid} (priority {cand.priority} > "
                  f"{victim.priority}, deadline {cand.deadline})")
        self._tenant_note(victim, "slot_preempt", "running->requeued", reason)
        admitted, shed, shed_reason = self.admission.offer(victim, self.tick)
        for req in shed:
            self._terminal.append(
                self._shed(req, f"preempted then {shed_reason}"))
        return []

    def _prefill(self, req: Request, tokens_list: list[int], cache_len: int):
        """Batch-1 prefill → (first token, padded caches) or the terminal
        request when the prompt is poisoned."""
        tokens = torch.tensor([tokens_list], dtype=torch.long,
                              device=self.device)
        try:
            logits, cache = self.model.prefill(self.params, {"tokens": tokens},
                                               cache_len=cache_len)
        except Exception as exc:
            return None, self._fail(req, f"prefill failed: {exc!r}")
        if not bool(torch.isfinite(logits).all()):
            return None, self._fail(req, "prefill produced non-finite logits")
        first = int(sample_token(logits, self.generator, req.temperature)[0])
        return first, cache

    def _admit(self, slot: int, req: Request) -> list[Request]:
        req.state = RequestState.RUNNING
        if not req.prompt:
            return [self._fail(req, "empty prompt")]
        # a preempted request resumes by replaying prompt + generated tokens
        tokens_list = list(req.prompt) + list(req.output)
        if len(tokens_list) >= self.max_len:
            return [self._fail(req, (
                f"token stream length {len(tokens_list)} exceeds KV "
                f"capacity (max_len={self.max_len}) at slot admission"))]
        if self.paged:
            return self._admit_paged(slot, req, tokens_list)
        if req.output:
            self.fault_stats["reprefilled_tokens"] += len(tokens_list)
        first, cache = self._prefill(req, tokens_list,
                                     self.max_len + self.cfg.meta_tokens)
        if first is None:
            return [cache]
        req.output.append(first)
        if (req.eos_id is not None and first == req.eos_id) \
                or len(req.output) >= req.max_tokens:
            return [self._complete(req)]
        _check_splice(self.caches, cache)
        for big, small in zip(_leaves(self.caches), _leaves(cache)):
            _splice(big, small, slot)
        self.slots[slot] = req
        self.pos[slot] = len(tokens_list)
        self.last_token[slot] = first
        return []

    # -- paged KV path ------------------------------------------------------------
    def _admit_paged(self, slot: int, req: Request,
                     tokens_list: list[int]) -> list[Request]:
        """Paged admission: allocate pages, prefill, scatter into pages; a
        preempted request that still holds pages resumes without a
        re-prefill."""
        if self.pool.holds(req.rid) and req.output:
            return self._resume_paged(slot, req, tokens_list)
        ps = self.pool.page_size
        meta = self.cfg.meta_tokens
        n_pos = len(tokens_list) + meta
        had_output = bool(req.output)
        faults = self._faults()
        keys = None
        shared = 0
        if self.prefix_sharing and not req.output:
            keys = page_content_keys(self.cfg.name, ps, tokens_list, meta)
            shared = self.pool.adopt_shared(req.rid, keys, req.tenant)
        try:
            if faults is not None:
                faults.fire("page_alloc")
            self.pool.ensure(req.rid, n_pos, req.tenant)
        except FaultInjected as exc:
            self.fault_stats["page_alloc_faults"] += 1
            return self._page_pressure(req, f"{exc}")
        except PageExhausted as exc:
            self.fault_stats["page_exhaustions"] += 1
            return self._page_pressure(req, str(exc))
        # page-aligned dense intermediate so the scatter covers every
        # written position
        first, cache = self._prefill(req, tokens_list,
                                     self._pages_per_req * ps)
        if first is None:
            return [cache]
        req.output.append(first)
        if had_output:
            self.fault_stats["reprefilled_tokens"] += len(tokens_list)
        if (req.eos_id is not None and first == req.eos_id) \
                or len(req.output) >= req.max_tokens:
            return [self._complete(req)]
        self._scatter_pages(req, cache, n_pos, skip_pages=shared)
        if keys is not None:
            self.pool.publish_keys(req.rid, keys)
        self.slots[slot] = req
        self.pos[slot] = len(tokens_list)
        self.last_token[slot] = first
        return []

    def _paged_step(self):
        """The paged decode step on the current slots' state."""
        return self._step([self.last_token, self.pos,
                           self._block_table_array()])

    def _resume_paged(self, slot: int, req: Request,
                      tokens_list: list[int]) -> list[Request]:
        """Resume a preempted request from its retained pages and decode ONE
        token (the tick a dense engine spends re-prefilling); the other
        slots' page writes in that step are value-identical to next tick's."""
        pos_i = len(tokens_list) - 1
        wp = pos_i + self.cfg.meta_tokens
        faults = self._faults()
        try:
            if faults is not None:
                faults.fire("page_alloc")
            self.pool.ensure(req.rid, wp + 1, req.tenant)
            page, copy_src = self.pool.writable_page(req.rid, wp)
        except FaultInjected as exc:
            self.fault_stats["page_alloc_faults"] += 1
            return self._page_pressure(req, f"{exc}")
        except PageExhausted as exc:
            self.fault_stats["page_exhaustions"] += 1
            return self._page_pressure(req, str(exc))
        if copy_src is not None:
            self._copy_page(page, copy_src)
        self.slots[slot] = req
        self.pos[slot] = pos_i
        self.last_token[slot] = tokens_list[-1]
        try:
            if faults is not None:
                faults.fire("block_table_build")
            logits = self._paged_step()
        except Exception as exc:
            logits = self._paged_fallback(exc)
            if logits is None:
                self._clear_slot(slot)
                return [self._fail(
                    req, f"paged resume decode failed: {exc!r}")]
        row = logits[slot:slot + 1]
        if not bool(torch.isfinite(row).all()):
            self._clear_slot(slot)
            return [self._fail(req, "resume decode produced non-finite logits")]
        nxt = int(sample_token(row, self.generator, req.temperature)[0])
        req.output.append(nxt)
        self.fault_stats["page_resumes"] += 1
        self.fault_stats["resumed_tokens"] += len(tokens_list)
        hit_eos = req.eos_id is not None and nxt == req.eos_id
        if hit_eos or len(req.output) >= req.max_tokens \
                or pos_i + 1 >= self.max_len - 1:
            self._clear_slot(slot)
            return [self._complete(req)]
        self.pos[slot] = pos_i + 1
        self.last_token[slot] = nxt
        return []

    def _page_pressure(self, req: Request, reason: str) -> list[Request]:
        """Page exhaustion / allocation fault: release what the request
        held and feed it back to the admission tier; past
        ``page_bounce_limit`` bounces (or with an empty pool) it is shed."""
        self.pool.release(req.rid)
        bounces = self._page_bounces.get(req.rid, 0) + 1
        self._page_bounces[req.rid] = bounces
        if bounces > self.page_bounce_limit or not self.pool.holders():
            self._page_bounces.pop(req.rid, None)
            return [self._shed(req, (
                f"page pressure: {reason} "
                f"(bounced {bounces}x, limit {self.page_bounce_limit})"))]
        req.state = RequestState.PENDING
        self._tenant_note(req, "page_alloc", "running->requeued", reason)
        admitted, shed, shed_reason = self.admission.offer(req, self.tick)
        return [self._shed(victim, f"page pressure requeue: {shed_reason}")
                for victim in shed]

    def _scatter_pages(self, req: Request, cache, n_pos: int,
                       skip_pages: int = 0) -> None:
        """Scatter a batch-1 dense prefill cache into this request's pages
        (skipping pages adopted via prefix sharing), in place."""
        ps = self.pool.page_size
        table = np.asarray(self.pool.table(req.rid), np.int64)
        positions = np.arange(skip_pages * ps, n_pos)
        if positions.size == 0:
            return
        pages = torch.from_numpy(table[positions // ps]).to(self.device)
        offs = torch.from_numpy(positions % ps).to(self.device)
        src = torch.from_numpy(positions).to(self.device)
        for paged, dense in zip(self.caches, cache):
            for p, d in zip(paged, dense):
                p[:, pages, offs] = d[:, 0, src].to(p.dtype)

    def _copy_page(self, dst: int, src: int) -> None:
        """Copy-on-write: duplicate page ``src`` into ``dst`` in every
        layer, in place."""
        for kv in self.caches:
            for leaf in kv:
                leaf[:, dst] = leaf[:, src]

    def _block_table_array(self) -> np.ndarray:
        """[max_slots, pages_per_req] int32; unused entries point at the
        null page 0 (decode masks by length, never by table bounds)."""
        bt = np.zeros((self.max_slots, self._pages_per_req), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            table = self.pool.table(req.rid)
            bt[i, :len(table)] = table[:self._pages_per_req]
        return bt

    def _paged_decode_tick(self) -> list[Request]:
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        out: list[Request] = []
        faults = self._faults()
        still = []
        for i in active:
            req = self.slots[i]
            wp = int(self.pos[i]) + self.cfg.meta_tokens
            try:
                if faults is not None:
                    faults.fire("page_alloc")
                self.pool.ensure(req.rid, wp + 1, req.tenant)
                page, copy_src = self.pool.writable_page(req.rid, wp)
            except FaultInjected as exc:
                self.fault_stats["page_alloc_faults"] += 1
                self._clear_slot(i)
                out.extend(self._page_pressure(req, f"{exc}"))
                continue
            except PageExhausted as exc:
                self.fault_stats["page_exhaustions"] += 1
                self._clear_slot(i)
                out.extend(self._page_pressure(req, str(exc)))
                continue
            if copy_src is not None:
                self._copy_page(page, copy_src)
            still.append(i)
        if not still:
            return out
        try:
            if faults is not None:
                faults.fire("block_table_build")
            logits = self._paged_step()
            if faults is not None:
                logits = faults.fire("decode_step", payload=logits)
        except Exception as exc:
            logits = self._paged_fallback(exc)
            if logits is None:
                for i in still:
                    req = self.slots[i]
                    self._clear_slot(i)
                    out.append(self._fail(
                        req, f"paged decode failed on both rungs: {exc!r}"))
                return out
        out.extend(self._advance_slots(still, logits))
        return out

    def _paged_fallback(self, exc: Exception):
        """Rung ``paged_decode → dense-gather``: returns logits, or None
        when the rescue rung itself failed."""
        if isinstance(exc, FaultInjected):
            self.fault_stats["block_table_faults"] += 1
        self.fault_stats["paged_decode_fallbacks"] += 1
        warnings.warn(
            f"paged decode failed ({exc!r}); falling back to the "
            "dense-gather decode step", DegradationWarning, stacklevel=3)
        if self.session is not None:
            self.session.note_degradation(
                "paged_decode", "paged->dense-gather", repr(exc), warn=False)
        try:
            return self._dense_gather_decode()
        except Exception:
            return None

    def _dense_gather_decode(self):
        """Gather every slot's pages into a dense [L,B,T,...] slab, run the
        eager dense decode, and scatter only the newly written position
        back into the pages.  Fires no fault site."""
        bt_np = self._block_table_array()
        bt = torch.from_numpy(bt_np).to(device=self.device, dtype=torch.long)
        maxp, ps = self._pages_per_req, self.pool.page_size

        def gather(leaf):
            g = leaf[:, bt]                      # [L, B, MAXP, ps, ...]
            return g.reshape(g.shape[0], g.shape[1], maxp * ps, *g.shape[4:])

        dense = [tuple(gather(leaf) for leaf in kv) for kv in self.caches]
        logits, dense = self.model.decode(
            self.params, self._on_device(self.last_token, torch.long), dense,
            self._on_device(self.pos, torch.int32))
        rows = [i for i, r in enumerate(self.slots) if r is not None]
        if rows:
            wp = np.array([int(self.pos[i]) + self.cfg.meta_tokens
                           for i in rows], np.int64)
            pages = torch.from_numpy(bt_np[rows, wp // ps].astype(np.int64))
            offs = torch.from_numpy(wp % ps)
            rows_t = torch.tensor(rows, dtype=torch.long)
            wp_t = torch.from_numpy(wp)
            idx = [t.to(self.device) for t in (pages, offs, rows_t, wp_t)]
            for paged, new in zip(self.caches, dense):
                for p, d in zip(paged, new):
                    p[:, idx[0], idx[1]] = d[:, idx[2], idx[3]].to(p.dtype)
        return logits

    def _decode_tick(self) -> list[Request]:
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        logits = None
        faults = self._faults()
        if self._use_compiled:
            # recurrent state, unlike a KV write, is not idempotent: keep
            # it so that the eager rung re-runs the step from it
            saved = [t.clone() for t in self._state_leaves]
            try:
                logits = self._step([self.last_token, self.pos])
                if faults is not None:
                    # raise mode → watchdog; corrupt mode → one poisoned
                    # slot (NaN row), caught per slot below.  Fired only on
                    # the compiled rung so the eager rescue never re-injects.
                    logits = faults.fire("decode_step", payload=logits)
            except Exception as exc:
                # step watchdog: latch onto the eager step; the graph writes
                # the KV caches in place, so re-running the step is
                # idempotent there, and recurrent state is restored first
                for leaf, kept in zip(self._state_leaves, saved):
                    leaf.copy_(kept)
                self.fault_stats["decode_faults"] += 1
                self.fault_stats["watchdog_fallbacks"] += 1
                self._use_compiled = False
                self._eager_clean_ticks = 0
                warnings.warn(
                    f"decode watchdog: graph step failed ({exc!r}); "
                    "falling back to the eager decode step",
                    DegradationWarning, stacklevel=2)
                if self.session is not None:
                    self.session.note_degradation(
                        "decode_step", "graph->eager", repr(exc), warn=False)
                logits = None
        if logits is None:
            try:
                logits = self._eager_decode()
            except Exception as exc:
                failed = []
                for i in active:
                    req = self.slots[i]
                    self._clear_slot(i)
                    failed.append(self._fail(
                        req, f"decode failed on both rungs: {exc!r}"))
                return failed
            # probation rung: after N clean eager ticks, retry the graph
            if not self._use_compiled and self.watchdog_probation > 0:
                self._eager_clean_ticks += 1
                if self._eager_clean_ticks >= self.watchdog_probation:
                    self._use_compiled = True
                    self._eager_clean_ticks = 0
                    self.fault_stats["watchdog_probations"] += 1
                    if self.session is not None:
                        self.session.note_degradation(
                            "decode_step", "eager->graph (probation)",
                            f"{self.watchdog_probation} clean eager ticks; "
                            "retrying the graph decode step", warn=False)
        return self._advance_slots(active, logits)

    def _advance_slots(self, active: list[int], logits) -> list[Request]:
        """Per-slot sampling/completion tail shared by the dense and paged
        decode ticks.  Greedy tokens and the finite check of every row come
        back in one device→host copy."""
        finite, greedy = torch.stack(
            [torch.isfinite(logits).all(dim=-1).long(),
             torch.argmax(logits, dim=-1)]).cpu().numpy()
        finished: list[Request] = []
        for i in active:
            req = self.slots[i]
            if not finite[i]:
                # poisoned request: evict THIS slot only
                self.fault_stats["decode_faults"] += 1
                finished.append(self._fail(
                    req, "decode produced non-finite logits"))
                self._clear_slot(i)
                continue
            t = int(greedy[i]) if req.temperature <= 0.0 else int(
                sample_token(logits[i:i + 1], self.generator,
                             req.temperature)[0])
            req.output.append(t)
            self.pos[i] += 1
            self.last_token[i] = t
            hit_eos = req.eos_id is not None and t == req.eos_id
            if hit_eos or len(req.output) >= req.max_tokens \
                    or self.pos[i] >= self.max_len - 1:
                finished.append(self._complete(req))
                self._clear_slot(i)
        return finished


def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of a cache tree — per stack a ``(k, v)`` tuple or a dict
    of recurrent-state leaves — in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _state_leaves(caches: list) -> list[torch.Tensor]:
    """The recurrent-state leaves of the stacked caches: every leaf of an
    RWKV stack's dict, the Mamba leaves of a hybrid stack's; no KV leaf."""
    return [leaf for stack in caches if isinstance(stack, dict)
            for key in sorted(stack) if key != "kv"
            for leaf in _leaves(stack[key])]


def _check_splice(big, small) -> None:
    """Raise before any leaf is written when a prefill's cache does not fit
    the slot cache leaf for leaf: a tuple of another arity (the JAX
    package's ``tree_map`` raises ``Tuple arity mismatch`` there, ROADMAP
    C19: the ``kv_quant`` int8 MLA slab against the prefill's bf16 latent)
    or a leaf of another dtype, which a copy would cast silently."""
    if isinstance(big, dict):
        for key in big:
            _check_splice(big[key], small[key])
    elif isinstance(big, (list, tuple)):
        if len(big) != len(small):
            raise ValueError(f"Tuple arity mismatch: {len(small)} != "
                             f"{len(big)} (a prefill cache against the slot "
                             "cache)")
        for b, s in zip(big, small):
            _check_splice(b, s)
    elif big.dtype != small.dtype:
        raise ValueError(f"cache dtype mismatch: {small.dtype} into "
                         f"{big.dtype}")


def _splice(big: torch.Tensor, small: torch.Tensor, slot: int) -> None:
    """Copy a batch-1 cache leaf ``[L,1,...]`` (KV ``[L,1,T,...]`` or a
    recurrent state) into the shared cache ``[L,B,...]`` at ``slot``, in
    place."""
    if big.dim() != small.dim():
        raise ValueError(f"cache rank mismatch {tuple(big.shape)} vs "
                         f"{tuple(small.shape)}")
    big[:, slot].copy_(small[:, 0])
