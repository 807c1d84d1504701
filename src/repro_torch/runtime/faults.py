"""Deterministic fault injection for the schedule/serve stack.

A :class:`FaultPlan` is a set of keyed injection sites that raise, corrupt
or delay when a guarded code path reaches them — so every recovery rung of
the degradation ladder (see ``docs/robustness.md``) is testable without
flaky real failures.  The plan is **clock-free and deterministic**: a site
fires on its first ``times`` activations (in program order) and then
disarms; nothing depends on wall time, thread timing or randomness.

Injection sites (one per ladder rung):

======================  ====================================================
``kernel_compile``      fused ``branch_gemm`` route at capture time (raises
                        out of capture)
``grouped_gemm_route``  ragged grouped-GEMM route at capture time (raises
                        out of capture)
``calibration_measure`` the profiling inference behind measured calibration
``calib_disk_read``     calibration disk-tier load (corrupt mode mangles the
                        JSON payload before parsing)
``calib_disk_write``    calibration disk-tier store (corrupt mode mangles
                        the payload; raise mode aborts before publish)
``plan_validate``       wave-schedule validation at the top of ``capture()``
``decode_step``         the serving engine's jitted decode step (corrupt
                        mode poisons one slot's logits — a poisoned request)
``admission_enqueue``   the serving admission tier's enqueue path (raise
                        mode sheds the incoming request with provenance)
``slot_preempt``        the engine's priority-preemption decision (raise
                        mode skips the preemption; the victim keeps running)
``deadline_check``      the engine's per-tick deadline sweep (raise mode
                        skips ONE tick of expiry)
``page_alloc``          the paged-KV pool's page grant (admission or
                        decode-time growth; raise mode becomes page
                        pressure — requeue/shed, never a crash)
``block_table_build``   assembly of the device block-table for a paged
                        decode tick (raise mode takes the tick down the
                        dense-gather fallback rung)
``page_release``        page release on request eviction (raise mode LEAKS
                        the pages — counted and visible in ``health()`` —
                        instead of corrupting the free list)
======================  ====================================================

Activation is either **per-session** (``SessionConfig(fault_plan=...)``,
or ``InferenceEngine(fault_plan=...)``) or **process-wide** for chaos CI
via the ``REPRO_TORCH_FAULT_PLAN`` environment variable / :func:`activate`::

    REPRO_TORCH_FAULT_PLAN="calibration_measure:raise:-1" pytest ...

Env grammar: ``site[:mode[:times[:arg]]]`` joined by ``;`` or ``,`` —
``mode`` one of ``raise`` / ``corrupt`` / ``delay`` (default ``raise``),
``times`` an int (``-1`` = every activation; default ``-1`` so a chaos run
keeps the fault live), ``arg`` a float whose meaning is per-mode (delay
seconds, or the row index corrupt mode poisons in an array payload).

A copy of the JAX package's ``runtime/faults.py``; only the array branch
of :func:`_corrupt` speaks torch.  In this package the ``kernel_compile`` and
``grouped_gemm_route`` sites raise out of capture: there is no slower rung
below a fused GEMM route.  This module imports nothing beyond the standard
library, so the kernel wrappers and the core compiler both reach it without
cycles.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Iterable

ENV_VAR = "REPRO_TORCH_FAULT_PLAN"

SITES = (
    "kernel_compile",
    "grouped_gemm_route",
    "calibration_measure",
    "calib_disk_read",
    "calib_disk_write",
    "plan_validate",
    "decode_step",
    "admission_enqueue",
    "slot_preempt",
    "deadline_check",
    "page_alloc",
    "block_table_build",
    "page_release",
)

MODES = ("raise", "corrupt", "delay")


class FaultInjected(RuntimeError):
    """Raised by a ``raise``-mode site.  Carries the site name so recovery
    paths and provenance records can attribute the failure."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at site {site!r}")
        self.site = site


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed site: what happens there and how many times."""

    site: str
    mode: str = "raise"
    times: int = -1          # activations that fire; -1 = every activation
    arg: float = 0.0         # delay seconds / corrupt row index

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {', '.join(SITES)}")
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; "
                             f"modes: {', '.join(MODES)}")


def _corrupt(payload: Any, arg: float) -> Any:
    """Deterministically mangle a payload the way real corruption would:
    strings/bytes are truncated mid-token (a torn write), arrays get one
    row (``int(arg)``) of NaNs (a poisoned batch slot), everything else is
    replaced by an unparseable sentinel."""
    if isinstance(payload, str):
        return payload[: max(1, len(payload) // 2)] + "\x00~CORRUPT~"
    if isinstance(payload, (bytes, bytearray)):
        return bytes(payload[: max(1, len(payload) // 2)]) + b"\x00~CORRUPT~"
    if hasattr(payload, "clone") and getattr(payload, "ndim", 0) >= 1:
        # tensor: poison one row of a copy, leave the rest of the batch intact
        out = payload.clone()
        out[int(arg)] = float("nan")
        return out
    return {"__corrupt__": True}


class FaultPlan:
    """Keyed, counted injection sites.  Mutable state is only the per-site
    activation counters — specs are frozen, so replaying the same program
    against the same plan fires identically every run."""

    def __init__(self, specs: Iterable[FaultSpec] = ()):
        self.specs: dict[str, FaultSpec] = {}
        for s in specs:
            if s.site in self.specs:
                raise ValueError(f"duplicate spec for site {s.site!r}")
            self.specs[s.site] = s
        self.activations: dict[str, int] = {s: 0 for s in self.specs}
        self.fired: dict[str, int] = {s: 0 for s in self.specs}
        # injectable clock for delay mode — the default is a no-op so plans
        # stay clock-free unless a harness explicitly wires a sleeper in
        self.sleep = lambda seconds: None

    # -- construction --------------------------------------------------------
    @classmethod
    def single(cls, site: str, mode: str = "raise", times: int = 1,
               arg: float = 0.0) -> "FaultPlan":
        return cls([FaultSpec(site=site, mode=mode, times=times, arg=arg)])

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse the ``REPRO_TORCH_FAULT_PLAN`` grammar (see module docstring)."""
        specs = []
        for token in text.replace(",", ";").split(";"):
            token = token.strip()
            if not token:
                continue
            parts = token.split(":")
            spec = FaultSpec(
                site=parts[0],
                mode=parts[1] if len(parts) > 1 and parts[1] else "raise",
                times=int(parts[2]) if len(parts) > 2 and parts[2] else -1,
                arg=float(parts[3]) if len(parts) > 3 and parts[3] else 0.0,
            )
            specs.append(spec)
        return cls(specs)

    # -- firing --------------------------------------------------------------
    def armed(self, site: str) -> bool:
        spec = self.specs.get(site)
        if spec is None:
            return False
        return spec.times < 0 or self.activations[site] < spec.times

    def fire(self, site: str, payload: Any = None) -> Any:
        """Activate ``site``: raise (``raise`` mode), return a corrupted
        ``payload`` (``corrupt``), or call the injected sleeper and pass the
        payload through (``delay``).  Disarmed / unkeyed sites are free:
        the payload passes through untouched and nothing is counted."""
        if not self.armed(site):
            return payload
        spec = self.specs[site]
        self.activations[site] += 1
        self.fired[site] += 1
        if spec.mode == "raise":
            raise FaultInjected(site)
        if spec.mode == "delay":
            self.sleep(spec.arg)
            return payload
        return _corrupt(payload, spec.arg)

    def describe(self) -> dict[str, dict[str, Any]]:
        return {
            site: {"mode": s.mode, "times": s.times, "arg": s.arg,
                   "fired": self.fired[site]}
            for site, s in self.specs.items()
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FaultPlan({', '.join(self.specs) or 'empty'})"


# =========================================================================
# Process-wide activation (chaos CI / direct kernel-wrapper callers)
# =========================================================================

_ACTIVE: FaultPlan | None = None
_ENV_CACHE: tuple[str, FaultPlan] | None = None


def get_active() -> FaultPlan | None:
    """The process-wide plan: an explicit :func:`activate` plan wins, else
    ``$REPRO_TORCH_FAULT_PLAN`` is parsed (cached per env-string so the fault-free
    hot path costs one dict lookup)."""
    if _ACTIVE is not None:
        return _ACTIVE
    text = os.environ.get(ENV_VAR)
    if not text:
        return None
    global _ENV_CACHE
    if _ENV_CACHE is None or _ENV_CACHE[0] != text:
        _ENV_CACHE = (text, FaultPlan.parse(text))
    return _ENV_CACHE[1]


class activate:
    """Context manager installing a process-wide plan (overrides the env)::

        with faults.activate(FaultPlan.single("kernel_compile")):
            ...
    """

    def __init__(self, plan: FaultPlan | None):
        self.plan = plan
        self._prev: FaultPlan | None = None

    def __enter__(self) -> FaultPlan | None:
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self.plan
        return self.plan

    def __exit__(self, *exc: Any) -> None:
        global _ACTIVE
        _ACTIVE = self._prev


def maybe_fire(site: str, payload: Any = None) -> Any:
    """Fire ``site`` on the process-wide plan, if any — the entry point for
    layers with no session in scope (the kernel wrappers)."""
    plan = get_active()
    if plan is None:
        return payload
    return plan.fire(site, payload)
