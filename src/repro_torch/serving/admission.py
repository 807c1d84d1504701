"""Overload-robust admission tier for the continuous-batching engine.

The engine's original request queue was an unbounded FIFO list: under any
sustained overload (arrival rate > slot capacity) it either grows without
bound or delivers useless late tokens.  This module is the admission tier
in front of the slot scheduler:

  * :class:`Request` carries multi-tenant serving metadata — ``tenant``,
    ``priority`` (higher = more important) and a ``deadline`` (absolute
    engine tick) or ``ttl`` (ticks from submission, resolved at submit);
  * :class:`AdmissionQueue` is a *bounded* queue with per-tenant quotas.
    A request that does not fit is **shed** (terminal
    :attr:`RequestState.SHED` with structured ``Request.error``
    provenance) instead of queued forever — under EDF policy an incoming
    urgent request displaces the least-urgent queued one rather than
    being dropped itself;
  * batch assembly is **EDF with priority classes**: the next admitted
    request is the highest-priority one with the earliest deadline
    (arrival order breaks ties, so a deadline-free, single-priority
    workload degenerates to exactly the legacy FIFO behavior);
  * :func:`deadline_critical` is the preemption trigger the engine uses
    to decide when a queued request must start *now* to have any chance
    of finishing inside its deadline.

Everything here is driven by the engine's deterministic **tick clock**
(one tick = one prefill or one batched decode step) — no wall-clock
anywhere, so shed/preempt/expire decisions replay identically in tests
and chaos runs.  See ``docs/robustness.md`` ("Serving tier under
overload") for the state machine and the shed/preempt/expire ladder.

A copy of the JAX package's ``serving/admission.py`` (pure Python, no framework code).
"""
from __future__ import annotations

import dataclasses
import enum


class RequestState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    # terminal: this request was poisoned (non-finite logits, prefill
    # failure, oversized prompt) and was evicted WITHOUT killing
    # co-batched requests
    FAILED = "failed"
    # terminal: refused at admission (queue bound, tenant quota, draining
    # engine, or displaced by a more urgent request)
    SHED = "shed"
    # terminal: deadline (or the run's tick budget) passed before
    # completion — queued or running, the request is evicted
    EXPIRED = "expired"


#: states a request can never leave; ``InferenceEngine.run`` guarantees
#: every submitted request ends in one of these
TERMINAL_STATES = frozenset(
    {RequestState.DONE, RequestState.FAILED, RequestState.SHED,
     RequestState.EXPIRED})


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_tokens: int = 32
    temperature: float = 0.0
    eos_id: int | None = None
    # -- multi-tenant admission metadata ----------------------------------
    tenant: str = "default"
    priority: int = 0                 # higher = more important
    deadline: int | None = None       # absolute engine tick; None = never
    ttl: int | None = None            # ticks from submit; resolved into
                                      # ``deadline`` by ``submit()``
    # -- lifecycle --------------------------------------------------------
    state: RequestState = RequestState.PENDING
    output: list[int] = dataclasses.field(default_factory=list)
    error: str | None = None          # diagnosis for FAILED/SHED/EXPIRED
    submit_tick: int = -1             # set by ``submit()``
    finish_tick: int = -1             # tick the request went terminal
    preemptions: int = 0              # times evicted for a more urgent one

    def ticks_needed(self) -> int:
        """Engine ticks to finish from a cold start: one prefill tick
        (emits the first token) plus one decode tick per remaining token.
        An upper bound — EOS may end it earlier."""
        return max(1, self.max_tokens - len(self.output))


_INF = float("inf")


def _deadline_key(req: Request) -> float:
    return _INF if req.deadline is None else float(req.deadline)


def urgency_key(req: Request, seq: int) -> tuple[float, float, int]:
    """EDF-within-priority-class ordering: smaller sorts first.  Arrival
    sequence breaks ties so equal-priority deadline-free traffic is FIFO."""
    return (-float(req.priority), _deadline_key(req), seq)


def feasible(req: Request, now: int) -> bool:
    """Can ``req`` still meet its deadline if admitted on the *next* tick?

    A request admitted at tick ``A`` (its prefill tick, emitting one
    token) finishes — absent EOS — at ``A + ticks_needed() - 1``; the
    earliest a queued request can be admitted is ``now + 1``, so it is
    feasible iff ``now + ticks_needed() <= deadline``.  Infeasible
    (doomed) requests are expired by the deadline sweep instead of
    burning slot time on tokens that can only arrive late."""
    if req.deadline is None:
        return True
    return now + req.ticks_needed() <= req.deadline


def deadline_critical(req: Request, now: int) -> bool:
    """True when a still-feasible ``req`` is nearly out of slack: unless
    it is admitted within the next tick or two it will miss its deadline.
    This is the engine's preemption trigger — preempting earlier wastes a
    victim a naturally freed slot would have avoided; later is too late."""
    if req.deadline is None or not feasible(req, now):
        return False
    return req.deadline - now <= req.ticks_needed() + 1


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission-tier policy knobs.  The defaults (unbounded queue, EDF
    with no deadlines/priorities in play) reproduce the legacy FIFO
    engine bit-for-bit, so existing single-tenant callers see no change.

    ``policy="fifo"`` disables *all* overload machinery (ordering,
    shedding-by-displacement, expiry, preemption still honor the other
    flags) — it exists as the measurable baseline for
    ``benchmarks/bench_serving.py``.
    """

    max_queue: int | None = None     # bound on queued requests; None = ∞
    tenant_quota: int | None = None  # max queued per tenant; None = ∞
    policy: str = "edf"              # "edf" | "fifo"
    preemption: bool = True          # evict a lower-priority running
                                     # request for a deadline-critical one
    expire_queued: bool = True       # expire queued requests past deadline
    expire_running: bool = True      # evict running requests past deadline

    def __post_init__(self) -> None:
        if self.policy not in ("edf", "fifo"):
            raise ValueError(f"unknown admission policy {self.policy!r}; "
                             "policies: edf, fifo")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        if self.tenant_quota is not None and self.tenant_quota < 1:
            raise ValueError("tenant_quota must be >= 1 (or None)")


class AdmissionQueue:
    """Bounded, quota'd, urgency-ordered queue of PENDING requests.

    Pure data structure + policy: it never mutates ``Request.state`` — the
    engine owns state transitions (and their provenance counters).  All
    decisions are deterministic functions of (config, arrival order,
    request metadata, tick).
    """

    def __init__(self, cfg: AdmissionConfig | None = None):
        self.cfg = cfg if cfg is not None else AdmissionConfig()
        self._items: list[tuple[int, Request]] = []   # (arrival seq, req)
        self._seq = 0

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return (req for _, req in self._items)

    def depth_by_tenant(self) -> dict[str, int]:
        depths: dict[str, int] = {}
        for _, req in self._items:
            depths[req.tenant] = depths.get(req.tenant, 0) + 1
        return depths

    # -- enqueue -----------------------------------------------------------
    def offer(self, req: Request, now: int) -> tuple[bool, list[Request],
                                                     str]:
        """Try to enqueue ``req``.  Returns ``(admitted, shed, reason)``:
        ``shed`` lists requests pushed out to make the decision hold —
        either ``[req]`` itself (quota / bound / FIFO overflow) or the
        displaced least-urgent queued request (EDF overflow where ``req``
        is more urgent).  ``reason`` diagnoses the shed, if any."""
        cfg = self.cfg
        if cfg.tenant_quota is not None:
            depth = sum(1 for _, r in self._items if r.tenant == req.tenant)
            if depth >= cfg.tenant_quota:
                return False, [req], (
                    f"tenant {req.tenant!r} over quota "
                    f"({depth}/{cfg.tenant_quota} queued)")
        if cfg.max_queue is not None and len(self._items) >= cfg.max_queue:
            if cfg.policy == "edf":
                worst_i = max(
                    range(len(self._items)),
                    key=lambda i: urgency_key(self._items[i][1],
                                              self._items[i][0]))
                worst_seq, worst = self._items[worst_i]
                # displace only a strictly less urgent request — the
                # incoming one inherits the *next* arrival seq, so an
                # equal-metadata newcomer never bumps an older request
                if urgency_key(req, self._seq) < urgency_key(worst,
                                                             worst_seq):
                    del self._items[worst_i]
                    self._push(req)
                    return True, [worst], (
                        f"queue full (max_queue={cfg.max_queue}); displaced "
                        f"by more urgent rid={req.rid}")
            return False, [req], f"queue full (max_queue={cfg.max_queue})"
        self._push(req)
        return True, [], ""

    def _push(self, req: Request) -> None:
        self._items.append((self._seq, req))
        self._seq += 1

    # -- selection ---------------------------------------------------------
    def _best_index(self) -> int | None:
        if not self._items:
            return None
        if self.cfg.policy == "fifo":
            return 0
        return min(range(len(self._items)),
                   key=lambda i: urgency_key(self._items[i][1],
                                             self._items[i][0]))

    def peek(self) -> Request | None:
        """Most urgent queued request (None when empty)."""
        i = self._best_index()
        return None if i is None else self._items[i][1]

    def pop_next(self) -> Request | None:
        """Remove and return the most urgent queued request."""
        i = self._best_index()
        if i is None:
            return None
        _, req = self._items.pop(i)
        return req

    # -- expiry / teardown ---------------------------------------------------
    def expire(self, now: int) -> list[tuple[Request, str]]:
        """Remove queued requests that can no longer meet their deadline —
        either the deadline has already passed, or the remaining slack is
        smaller than the ticks they still need (doomed: every token they
        would produce is guaranteed late).  Returns ``(request, reason)``
        pairs; the engine marks them EXPIRED."""
        if not self.cfg.expire_queued:
            return []
        expired: list[tuple[Request, str]] = []
        for _, req in self._items:
            if req.deadline is None:
                continue
            if now > req.deadline:
                expired.append((req, f"deadline {req.deadline} passed in "
                                     f"queue at tick {now}"))
            elif not feasible(req, now):
                expired.append((req, (
                    f"infeasible in queue: needs {req.ticks_needed()} ticks "
                    f"but deadline {req.deadline} is "
                    f"{req.deadline - now} ticks away")))
        if expired:
            gone = set(id(r) for r, _ in expired)
            self._items = [(s, r) for s, r in self._items
                           if id(r) not in gone]
        return expired

    def clear(self) -> list[Request]:
        """Remove and return everything still queued (run-teardown path)."""
        out = [req for _, req in self._items]
        self._items = []
        return out
