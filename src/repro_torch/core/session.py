"""Configuration-scoped compilation sessions.

``Session`` is the one object a user hands a model graph to::

    from repro_torch.core import Session, SessionConfig

    sess = Session(SessionConfig(autotune=True))   # on the CUDA card
    model = sess.compile(graph, inputs=profiling_inputs)
    outs = model({"tokens": x})
    model.explain()          # per-stage timings + cache provenance

A session bundles every knob that used to travel as a kwarg cross-product
through ``api.plan`` / ``api.optimize`` / ``api.calibrate`` (hardware,
policies, simulator config, autotune, calibration and cache sizing) into one
frozen :class:`SessionConfig`, and owns ALL cache state: the plan,
executable and calibration LRUs plus the calibration disk tier live on the
session, not in module globals.  Two sessions never share entries; serving
fleets, benchmarks and tests each get an isolated, composable entry point,
and new configuration axes (multi-device lanes, IOS-style refinement
schedules) extend ``SessionConfig`` instead of widening three function
signatures.

A session runs on the CUDA card (``SessionConfig.device="cuda"``, the
default) and schedules for the card's data-sheet spec
(:func:`repro_torch.core.profiler.detect_hardware`) unless ``hw`` is given;
without a card it raises.  ``device="cpu"`` runs on the CPU and then needs
``hw`` explicitly.  A copy of the JAX package's ``core/session.py``
otherwise, minus the capture-route degradations that this package does not
take (a fused route that fails raises).

The legacy module functions in :mod:`repro_torch.core.api` remain as thin
shims that delegate to a process-wide :func:`default_session` and emit
``DeprecationWarning`` when passed the superseded configuration kwargs.

Cache semantics are unchanged from the module-global era — see the table in
``docs/api.md``:

* **plan** — keyed by the structural :func:`graph_signature` (policies, hw,
  lanes, sim_cfg and the hydrated calibration fingerprint); a hit on a
  different graph object is rebound (op_ids are structural).
* **executable** — plan key + a weights fingerprint (``identity`` or
  ``content``) + output ids + kernel route.
* **calibration** — (node_signature, input_signature, hw.name), memory LRU
  over a JSON disk tier under ``SessionConfig.calib_dir`` (default
  ``$REPRO_TORCH_CALIB_DIR`` or ``~/.cache/repro_torch/calib``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Any, Mapping

import torch

from .. import trace as _trace
from ..runtime.faults import FaultPlan, get_active as _active_faults
from ..runtime.guard import DegradationLog, retry_with_backoff
from .capture import GEMM_KERNELS, CapturedGraph, PlanValidationError
from .graph import OpGraph
from .launch_order import ORDER_POLICIES
from .profiler import (
    HardwareSpec,
    ModelProfiler,
    ProfileTable,
    V5E,
    apply_profile,
    detect_hardware,
)
from .scheduler import (
    ALLOC_POLICIES,
    RefineConfig,
    SchedulePlan,
    _normalize_refine,
    compile_plan,
    schedule,
)
from .scheduler import autotune as autotune_schedule
from .simulator import SimConfig

_CACHE_SIZE = 64          # default LRU bound (``SessionConfig.cache_size``)
_CALIB_DIR_ENV = "REPRO_TORCH_CALIB_DIR"
_DISK_CACHE_MAX = 512     # default disk-tier bound

_STAT_KEYS = ("plan_hits", "plan_misses", "exec_hits", "exec_misses",
              "calib_hits", "calib_misses", "calib_disk_hits",
              # graceful-degradation provenance (docs/robustness.md):
              "calib_retries",             # measure re-attempts that happened
              "calib_degraded_analytic",   # measured→analytic degradations
              "calib_disk_errors",         # disk tier read/write failures
              "degraded_routes")           # capture/plan fallback edges taken

# fault-proof sentinel for ladder-floor paths: an empty plan fires nothing
# AND suppresses the process-wide/env plan (passing None would re-resolve it)
_NO_FAULTS = FaultPlan()


# =========================================================================
# Configuration
# =========================================================================

@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Everything a compilation pipeline reads, bundled and immutable.

    Frozen + hashable: a config can serve as a cache-key component and two
    sessions built from equal configs behave identically (but still never
    share cache state — isolation is per ``Session`` instance).
    """

    # -- device -------------------------------------------------------------
    device: str = "cuda"                  # cuda | cpu
    # -- scheduling ---------------------------------------------------------
    hw: HardwareSpec | None = None        # None → the CUDA card's spec
    alloc_policy: str = "opara"
    order_policy: str = "opara"
    max_lanes: int | None = None
    autotune: bool = False                # simulator-guided {alloc}×{order}×{repack}
    refine: bool | RefineConfig = False   # IOS-style iterative refinement of
                                          # the autotune winner (needs autotune)
    sim_cfg: SimConfig | None = None      # cost model for autotune / repack
    # -- capture / executable ----------------------------------------------
    gemm_kernel: str = "auto"             # auto | kernel | vmap
    weights_key: str = "identity"         # identity | content
    # -- measured-profile calibration --------------------------------------
    calibration_repeats: int = 3
    load_calibration: bool = True         # consult the disk tier
    calib_dir: str | None = None          # None → $REPRO_TORCH_CALIB_DIR / default
    # -- graceful degradation (docs/robustness.md) --------------------------
    calib_retries: int = 2                # measure re-attempts before the
                                          # analytic-profile degrade
    calib_backoff_s: float = 0.0          # base retry backoff (doubles per
                                          # attempt; clock is injectable via
                                          # Session._sleep, 0 = no waiting)
    fault_plan: FaultPlan | None = None   # per-session injection plan (None
                                          # → $REPRO_FAULT_PLAN, if set)
    # -- cache sizing -------------------------------------------------------
    cache_size: int = _CACHE_SIZE         # per-session LRU bound (each tier)
    disk_cache_entries: int = _DISK_CACHE_MAX

    def __post_init__(self) -> None:
        if self.alloc_policy not in ALLOC_POLICIES:
            raise ValueError(f"unknown alloc_policy {self.alloc_policy!r}")
        if self.order_policy not in ORDER_POLICIES:
            raise ValueError(f"unknown order_policy {self.order_policy!r}")
        if self.weights_key not in ("identity", "content"):
            raise ValueError(f"unknown weights_key {self.weights_key!r}")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {self.device!r}")
        if self.gemm_kernel not in GEMM_KERNELS:
            raise ValueError(f"unknown gemm_kernel {self.gemm_kernel!r}")
        if self.cache_size < 1:
            raise ValueError("cache_size must be >= 1")
        if self.calib_retries < 0:
            raise ValueError("calib_retries must be >= 0")
        if self.calib_backoff_s < 0:
            raise ValueError("calib_backoff_s must be >= 0")
        # raises TypeError on junk values; None means refinement is off
        if _normalize_refine(self.refine) is not None and not self.autotune:
            raise ValueError("refine requires autotune=True (refinement "
                             "starts from the autotune winner)")


# =========================================================================
# Cache keys (pure functions of graph + config — shared with api shims)
# =========================================================================

def graph_signature(
    graph: OpGraph,
    alloc_policy: str = "opara",
    order_policy: str = "opara",
    hw: HardwareSpec = V5E,
    max_lanes: int | None = None,
    sim_cfg: SimConfig | None = None,
) -> tuple:
    """Structural cache key: everything scheduling reads, nothing it doesn't.

    Per node: kind, edges, output shape/dtype, fusion signature, analytic
    cost fields (including the derived ``resource_demand()`` the repacker
    admits on), payload marker and const shapes (capture's stackability
    inputs) — see :meth:`OpGraph.node_signature`, which memoizes the node
    part per graph version.  The hydrated calibration fingerprint (if any)
    is a separate component: measured timings change schedules, but they are
    not part of the graph's structural identity.  ``sim_cfg`` (a frozen,
    hashable :class:`SimConfig`) joins the key for autotuned plans — the
    cost model's resource cap and penalties steer the search, so two
    configs must never share a tuned plan.  Weight *values* and payload
    identities are deliberately excluded — they cannot change a schedule.

    The per-node part enters as :meth:`OpGraph.signature_digest` (memoized
    sha1 of the full node tuple) so cache probes stay O(1) in graph size.
    """
    return (graph.signature_digest(), graph.calibration_fp,
            alloc_policy, order_policy, hw, max_lanes, sim_cfg)


def calibration_key(graph: OpGraph, inputs: Mapping[int, Any],
                    hw: HardwareSpec = V5E) -> tuple:
    """Calibration-cache key: structure × input geometry × hardware."""
    return (graph.node_signature(), graph.input_signature(inputs), hw.name)


def _content_digest(a: torch.Tensor) -> tuple:
    t = a.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:     # numpy has no bfloat16: hash the bits
        t = t.view(torch.int16)
    return (str(a.dtype), tuple(a.shape),
            hashlib.sha1(t.numpy().tobytes()).hexdigest())


def _weights_fingerprint(graph: OpGraph, weights_key: str = "identity") -> tuple:
    """Fingerprint of every payload + const array (executable cache key part).

    ``identity`` — ``id()`` of callables and arrays (fast; live-object safe
    because cached executables pin their graph).  ``content`` — code-object
    identity for callables (stable across re-created lambdas from the same
    source) + a byte digest of each const, so recreated-but-equal arrays
    (checkpoint reload) share the executable.
    """
    if weights_key == "identity":
        return tuple(
            (id(n.fn), tuple(id(c) for c in n.meta.get("consts", ())))
            for n in graph
        )
    if weights_key == "content":
        return tuple(
            (id(getattr(n.fn, "__code__", n.fn)),
             tuple(_content_digest(c) for c in n.meta.get("consts", ())))
            for n in graph
        )
    raise ValueError(f"unknown weights_key {weights_key!r}")


def _autotune_key_parts(sim_cfg: SimConfig | None) -> tuple[str, str, SimConfig]:
    """The autotuned-plan cache-key normalization, shared by the plan and
    executable paths so their keys can never drift: policy slots carry a
    sentinel (the tuner picks the real policies) and sim_cfg defaults the
    same way :func:`repro_torch.core.scheduler.autotune` does, so an explicit
    default ``SimConfig()`` shares the implicit-``None`` entry."""
    return "__autotune__", "__autotune__", sim_cfg or SimConfig()


def _policy_parts(cfg: SessionConfig) -> tuple[str, str, SimConfig | None]:
    """(alloc, order, sim_cfg) as they enter cache keys and the scheduler —
    normalized through :func:`_autotune_key_parts` under autotune.  The ONE
    source for both the plan-cache and executable-cache keys, so they stay
    byte-identical by construction."""
    if cfg.autotune:
        return _autotune_key_parts(cfg.sim_cfg)
    return cfg.alloc_policy, cfg.order_policy, cfg.sim_cfg


def _plan_key(graph: OpGraph, cfg: SessionConfig) -> tuple:
    alloc, order, sim_cfg = _policy_parts(cfg)
    # Refinement changes the plan an autotune search returns, so the
    # normalized RefineConfig (frozen + hashable; ``True`` and an explicit
    # default config normalize identically) joins the key.  Off — or
    # single-policy scheduling, which never refines — contributes ``None``.
    refine = _normalize_refine(cfg.refine) if cfg.autotune else None
    return graph_signature(graph, alloc, order, cfg.hw,
                           cfg.max_lanes, sim_cfg) + (refine,)


# =========================================================================
# LRU + calibration disk tier primitives
# =========================================================================

def _lru_get(cache: OrderedDict, key: tuple) -> Any | None:
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    return None


def _lru_put(cache: OrderedDict, key: tuple, value: Any,
             max_entries: int = _CACHE_SIZE) -> None:
    cache[key] = value
    cache.move_to_end(key)
    while len(cache) > max_entries:
        cache.popitem(last=False)


def _calib_dir(override: str | None = None) -> str:
    return override or os.environ.get(_CALIB_DIR_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "calib")


def _calib_path(key: tuple, dirpath: str | None = None) -> str:
    digest = hashlib.sha1(repr(key).encode()).hexdigest()
    return os.path.join(_calib_dir(dirpath), f"{digest}.json")


def _calib_disk_load(key: tuple, dirpath: str | None = None,
                     faults: FaultPlan | None = None) -> ProfileTable | None:
    """Read one disk-tier entry.  Corruption-safe by construction: torn or
    mangled JSON (real, or injected via the ``calib_disk_read`` corrupt
    mode) parses to ``None`` → the caller treats it as a miss.  A
    raise-mode fault propagates (the session's guard counts it and degrades
    to the memory tier)."""
    try:
        with open(_calib_path(key, dirpath)) as f:
            raw = f.read()
        if faults is not None:
            raw = faults.fire("calib_disk_read", payload=raw)
        doc = json.loads(raw)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("key") != repr(key):
        return None               # sha1 collision / stale format / corrupt
    try:
        return ProfileTable(
            hw_name=doc["hw_name"],
            measured_us=tuple((int(i), float(us))
                              for i, us in doc["measured_us"]))
    except (KeyError, TypeError, ValueError):
        return None               # structurally corrupt entry → miss


def _calib_disk_store(key: tuple, table: ProfileTable,
                      dirpath: str | None = None,
                      max_entries: int = _DISK_CACHE_MAX,
                      faults: FaultPlan | None = None) -> None:
    """Best-effort atomic write; serving must never fail on a full disk.

    The write is tmp-file + ``os.replace``, so a crash mid-write (including
    an injected ``calib_disk_write`` raise) never publishes a partial entry
    and never strands the temp file.  Corrupt-mode injection mangles the
    payload *content* — the published entry is then atomically whole but
    unparseable, which the read path survives as a miss."""
    d = _calib_dir(dirpath)
    tmp = None
    try:
        payload = json.dumps({"key": repr(key), "hw_name": table.hw_name,
                              "measured_us": [list(m)
                                              for m in table.measured_us]})
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        if faults is not None:
            payload = faults.fire("calib_disk_write", payload=payload)
        with os.fdopen(fd, "w") as f:
            f.write(payload)
        os.replace(tmp, _calib_path(key, dirpath))
        tmp = None
        _calib_disk_evict(d, max_entries)
    except OSError:
        pass                      # full disk / permissions: memory tier only
    finally:                      # injected faults reach the session's guard
        if tmp is not None:       # never strand the temp file
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _calib_disk_evict(d: str, max_entries: int = _DISK_CACHE_MAX) -> None:
    """Drop oldest-mtime entries beyond ``max_entries`` (runs per store —
    rare: stores happen only on full cache misses)."""
    try:
        entries = [e for e in os.scandir(d) if e.name.endswith(".json")]
        if len(entries) <= max_entries:
            return
        entries.sort(key=lambda e: e.stat().st_mtime)
        for e in entries[:len(entries) - max_entries]:
            try:
                os.unlink(e.path)
            except OSError:
                pass
    except OSError:
        pass


# =========================================================================
# CompiledModel
# =========================================================================

@dataclasses.dataclass
class CompiledModel:
    """Handle returned by :meth:`Session.compile`: plan + executable +
    build provenance.  Calling it runs the fused program.

    Holds the (immutable) :class:`SessionConfig` it was built under — NOT
    the session itself, so a long-lived model handle never pins a discarded
    session's caches alive."""

    config: SessionConfig
    graph: OpGraph
    plan: SchedulePlan
    executable: CapturedGraph
    # "calibration": measured | memory | disk | analytic (degraded) | off
    # "plan" / "executable": hit | miss | degraded
    provenance: dict[str, str]
    timings_ms: dict[str, float]          # calibrate / plan / compile / total
    # structured fallback events recorded while THIS model was built
    # (site / action / reason dicts — see docs/robustness.md)
    degradations: list[dict[str, str]] = dataclasses.field(
        default_factory=list)

    def __call__(self, inputs: Mapping[str | int, Any]) -> list:
        return self.executable(inputs)

    @property
    def stats(self) -> dict[str, float]:
        """Packing/scheduling efficacy of the underlying plan."""
        return self.plan.stats()

    def explain(self) -> dict[str, Any]:
        """Where this executable came from: per-stage wall times and, for
        each cache tier, whether the build hit or missed (and for
        calibration, whether the hit came from memory or disk)."""
        cfg = self.config
        p = self.plan
        return {
            "graph": {"name": self.graph.name, "n_ops": len(self.graph)},
            "config": {
                "hw": cfg.hw.name,
                "alloc_policy": p.alloc_policy,   # tuned value under autotune
                "order_policy": p.order_policy,
                "autotune": cfg.autotune,
                "refine": _normalize_refine(cfg.refine) is not None,
                "gemm_kernel": cfg.gemm_kernel,
                "weights_key": cfg.weights_key,
            },
            "cache": dict(self.provenance),
            "degraded": list(self.degradations),
            "stages_ms": dict(
                self.timings_ms,
                alloc=p.alloc_time_ms,
                order=p.order_time_ms,
                profile=p.profile_time_ms,
                waves=p.wave_time_ms,
                autotune=p.autotune_ms,
                refine=p.refine_ms,
            ),
            "schedule": {
                "n_streams": p.n_streams,
                "n_waves": p.waves.n_waves,
                "repacked": p.repacked,
                "refined": p.refined,
                "refine_iters": p.refine_iters,
                "refine_delta_us": p.refine_delta_us,
                "est_makespan_us": p.est_makespan_us,
            },
        }


# =========================================================================
# Session
# =========================================================================

class Session:
    """Configuration-scoped compiler with isolated cache state.

    ``Session(cfg)`` or ``Session(autotune=True, ...)`` (kwargs build /
    override a :class:`SessionConfig`).  All methods read configuration from
    ``self.config`` only; per-call data (graphs, profiling inputs, output
    ids) stays in the call.
    """

    def __init__(self, config: SessionConfig | None = None, **overrides: Any):
        base = config if config is not None else SessionConfig()
        cfg = dataclasses.replace(base, **overrides) if overrides else base
        if cfg.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Session runs on the CUDA card and none is "
                               "present; pass device='cpu' (and hw=) to run "
                               "on the CPU")
        if cfg.hw is None:
            if cfg.device == "cpu":
                raise ValueError("a CPU session needs an explicit hw= "
                                 "HardwareSpec to schedule for")
            cfg = dataclasses.replace(cfg, hw=detect_hardware())
        self.config = cfg
        self._plan_cache: OrderedDict[tuple, SchedulePlan] = OrderedDict()
        self._exec_cache: OrderedDict[tuple, CapturedGraph] = OrderedDict()
        self._calib_cache: OrderedDict[tuple, ProfileTable] = OrderedDict()
        self._stats = {k: 0 for k in _STAT_KEYS}
        # structured record of every fallback this session took
        self.guard_log = DegradationLog()
        # injectable clock for calibration retry backoff (tests swap it)
        self._sleep = time.sleep

    @property
    def faults(self) -> FaultPlan | None:
        """The armed injection plan: per-session config wins, else the
        process-wide/env plan (resolved lazily so chaos harnesses can arm
        ``$REPRO_FAULT_PLAN`` around an existing session)."""
        return (self.config.fault_plan if self.config.fault_plan is not None
                else _active_faults())

    def note_degradation(self, site: str, action: str, reason: str,
                         warn: bool = True) -> None:
        """Record an externally detected degradation against this session
        (e.g. the serving engine's measured→analytic calibration fallback)
        so ``cache_stats()`` provenance stays complete."""
        self.guard_log.note(site, action, reason, warn=warn)
        if site == "calibration_measure":
            self._stats["calib_degraded_analytic"] += 1
        elif site in ("calib_disk_read", "calib_disk_write"):
            self._stats["calib_disk_errors"] += 1
        else:
            self._stats["degraded_routes"] += 1

    # -- calibration --------------------------------------------------------
    def calibrate(self, graph: OpGraph, inputs: Mapping[int, Any],
                  repeats: int | None = None,
                  load: bool | None = None) -> ProfileTable | None:
        """Hydrate ``graph`` with a measured profile, timing at most once.

        Memory-cache hit → the stored table is re-applied (zero re-timing);
        memory miss → the disk tier is consulted (``load=False`` — or
        ``SessionConfig.load_calibration=False`` — skips it, e.g. after a
        runtime upgrade invalidates persisted timings); full miss → one
        profiling inference (the paper's "profile each DNN inference only
        once"), stored to both tiers for every structurally identical graph
        — including one built by a later process — that follows.

        If measurement keeps failing after ``SessionConfig.calib_retries``
        re-attempts, the session degrades to the analytic cost model:
        ``None`` is returned, one :class:`DegradationWarning` is emitted and
        ``cache_stats()["calib_degraded_analytic"]`` increments — scheduling
        proceeds on analytic costs instead of crashing the build.
        """
        table, _ = self._calibrate(graph, inputs, self.config,
                                   repeats=repeats, load=load)
        return table

    def _calibrate(self, graph: OpGraph, inputs: Mapping[int, Any],
                   cfg: SessionConfig, repeats: int | None = None,
                   load: bool | None = None) -> tuple[ProfileTable | None, str]:
        repeats = cfg.calibration_repeats if repeats is None else repeats
        load = cfg.load_calibration if load is None else load
        key = calibration_key(graph, inputs, cfg.hw)
        faults = self.faults
        provenance = "memory"
        table = _lru_get(self._calib_cache, key)
        if table is not None:
            self._stats["calib_hits"] += 1            # memory-tier hit
        else:
            disk = None
            if load:
                try:
                    disk = _calib_disk_load(key, cfg.calib_dir, faults=faults)
                except Exception as exc:              # injected / exotic I/O
                    self._stats["calib_disk_errors"] += 1
                    self.guard_log.note("calib_disk_read",
                                        "disk->memory-tier", repr(exc))
            if disk is not None:
                self._stats["calib_disk_hits"] += 1   # disk-tier hit
                provenance = "disk"
                table = disk
                _lru_put(self._calib_cache, key, table, cfg.cache_size)
            else:
                table, provenance = self._measure_or_degrade(
                    graph, inputs, cfg, key, repeats, faults)
        if table is not None and graph.calibration_fp != table.fingerprint:
            apply_profile(graph, table)
        return table, provenance

    def _measure_or_degrade(self, graph: OpGraph, inputs: Mapping[int, Any],
                            cfg: SessionConfig, key: tuple, repeats: int,
                            faults: FaultPlan | None,
                            ) -> tuple[ProfileTable | None, str]:
        """Full-miss rung of the calibration ladder: measure (with bounded
        retry + backoff), then — only if every attempt failed — degrade to
        the analytic cost model rather than fail the build."""
        self._stats["calib_misses"] += 1

        def _measure() -> ProfileTable:
            if faults is not None:
                faults.fire("calibration_measure")
            return ModelProfiler(cfg.hw).measure(graph, inputs,
                                                 repeats=repeats)

        def _on_retry(attempt: int, exc: BaseException) -> None:
            self._stats["calib_retries"] += 1
            self.guard_log.note("calibration_measure",
                                f"retry#{attempt + 1}", repr(exc))

        try:
            table = retry_with_backoff(_measure, retries=cfg.calib_retries,
                                       base_delay_s=cfg.calib_backoff_s,
                                       sleep=self._sleep, on_retry=_on_retry)
        except Exception as exc:
            self._stats["calib_degraded_analytic"] += 1
            self.guard_log.note("calibration_measure", "measured->analytic",
                                repr(exc), warn=True)
            return None, "analytic (degraded)"
        _lru_put(self._calib_cache, key, table, cfg.cache_size)
        try:
            _calib_disk_store(key, table, cfg.calib_dir,
                              cfg.disk_cache_entries, faults=faults)
        except Exception as exc:                      # injected write fault
            self._stats["calib_disk_errors"] += 1
            self.guard_log.note("calib_disk_write", "disk->memory-tier",
                                repr(exc))
        return table, "measured"

    # -- planning -----------------------------------------------------------
    def plan(self, graph: OpGraph,
             measured_inputs: Mapping[int, Any] | None = None,
             cache: bool = True) -> SchedulePlan:
        """Cached scheduling under this session's config.  With
        ``config.autotune`` the single-policy pipeline is replaced by the
        simulator-guided search (``alloc_policy``/``order_policy`` are then
        ignored — the tuner picks them); the search result lands in the same
        plan cache, so the warm path costs the same either way.
        ``measured_inputs`` routes through :meth:`calibrate` first."""
        p, _ = self._plan(graph, self.config,
                          measured_inputs=measured_inputs, cache=cache)
        return p

    def _plan(self, graph: OpGraph, cfg: SessionConfig,
              measured_inputs: Mapping[int, Any] | None = None,
              cache: bool = True) -> tuple[SchedulePlan, str]:
        alloc, order, sim_cfg = _policy_parts(cfg)
        if not cache:
            if cfg.autotune:
                return autotune_schedule(
                    graph, hw=cfg.hw, cfg=sim_cfg, max_lanes=cfg.max_lanes,
                    measured_inputs=measured_inputs,
                    refine=cfg.refine), "uncached"
            return schedule(
                graph, alloc, order, cfg.hw, max_lanes=cfg.max_lanes,
                measured_inputs=measured_inputs, sim_cfg=sim_cfg), "uncached"
        if measured_inputs is not None:
            self._calibrate(graph, measured_inputs, cfg)
        key = _plan_key(graph, cfg)
        hit = _lru_get(self._plan_cache, key)
        if hit is not None:
            self._stats["plan_hits"] += 1
            if hit.graph is graph:
                return hit, "hit"
            # same structure, different graph object: rebind (op_ids match)
            return dataclasses.replace(hit, graph=graph), "hit"
        self._stats["plan_misses"] += 1
        # measured timings (if any) are already hydrated onto node costs, so
        # the plain pipeline schedules with them — no re-timing here.
        if cfg.autotune:
            p = autotune_schedule(graph, hw=cfg.hw, cfg=sim_cfg,
                                  max_lanes=cfg.max_lanes, refine=cfg.refine)
        else:
            p = schedule(graph, alloc, order, cfg.hw,
                         max_lanes=cfg.max_lanes, sim_cfg=sim_cfg)
        _lru_put(self._plan_cache, key, p, cfg.cache_size)
        return p, "miss"

    # -- capture ------------------------------------------------------------
    def optimize(self, graph: OpGraph, output_ids=None,
                 cache: bool = True) -> CapturedGraph:
        """Full pipeline → cached executable (plan + capture)."""
        p, _ = self._plan(graph, self.config, cache=cache)
        exe, _ = self._capture(graph, self.config, p,
                               output_ids=output_ids, cache=cache)
        return exe

    def _capture(self, graph: OpGraph, cfg: SessionConfig, p: SchedulePlan,
                 output_ids=None, cache: bool = True) -> tuple[CapturedGraph, str]:
        if not cache:
            return compile_plan(p, output_ids=output_ids,
                                gemm_kernel=cfg.gemm_kernel,
                                faults=self.faults), "uncached"
        key = (
            _plan_key(graph, cfg),   # byte-identical to the plan-cache key
            cfg.weights_key,
            _weights_fingerprint(graph, cfg.weights_key),
            tuple(output_ids) if output_ids is not None else None,
            cfg.gemm_kernel,
        )
        hit = _lru_get(self._exec_cache, key)
        if hit is not None:
            self._stats["exec_hits"] += 1
            return hit, "hit"
        self._stats["exec_misses"] += 1
        try:
            exe = compile_plan(p, output_ids=output_ids,
                               gemm_kernel=cfg.gemm_kernel,
                               faults=self.faults)
        except PlanValidationError as exc:
            # Corrupt plan (injected or real): re-schedule single-stream
            # sequential and compile that with no injection — the same ops
            # in dependency order, so outputs are identical.  Any other
            # capture failure (a fused route that cannot be built) raises.
            self._stats["degraded_routes"] += 1
            self.guard_log.note("plan_validate", "schedule->sequential",
                                repr(exc), warn=True)
            safe = schedule(graph, "sequential", "topo", cfg.hw)
            exe = compile_plan(safe, output_ids=output_ids,
                               gemm_kernel="vmap", faults=_NO_FAULTS)
            return exe, "degraded"   # never cached: fault may be transient
        _lru_put(self._exec_cache, key, exe, cfg.cache_size)
        return exe, "miss"

    # -- the one-call entry point -------------------------------------------
    def compile(self, graph: OpGraph,
                inputs: Mapping[int, Any] | None = None,
                output_ids=None) -> CompiledModel:
        """Run the whole pipeline and return a :class:`CompiledModel`.

        ``inputs`` (optional) are profiling inputs on the session's device:
        when given, the graph is calibrated with measured timings first
        (cache-amortized).  The returned handle exposes ``.plan``,
        ``.executable``, ``.stats`` and ``.explain()`` — per-stage wall
        times plus, for every cache tier, whether this build hit or missed.
        """
        cfg = self.config
        if inputs is not None:
            for a in inputs.values():
                if isinstance(a, torch.Tensor) and a.device.type != cfg.device:
                    raise ValueError(f"input on {a.device} for a "
                                     f"{cfg.device} session")
        # timings_ms is read from the build's spans, timed whether tracing
        # is on or not: "compile" is the capture stage, "total" the build
        timings = {"calibrate": 0.0, "plan": 0.0, "compile": 0.0}
        with _trace.span("compile", timed=True) as total:
            mark = len(self.guard_log)    # events from THIS build start here
            provenance = {"calibration": "off"}
            if inputs is not None:
                with _trace.span("compile.calibrate", timed=True) as t:
                    _, provenance["calibration"] = self._calibrate(
                        graph, inputs, cfg)
                timings["calibrate"] = t.ms
            with _trace.span("compile.plan", timed=True) as t:
                p, provenance["plan"] = self._plan(graph, cfg)
            timings["plan"] = t.ms
            with _trace.span("compile.capture", timed=True) as t:
                exe, provenance["executable"] = self._capture(
                    graph, cfg, p, output_ids=output_ids)
            timings["compile"] = t.ms
        timings["total"] = total.ms
        return CompiledModel(config=cfg, graph=graph, plan=p,
                             executable=exe, provenance=provenance,
                             timings_ms=timings,
                             degradations=[e.as_dict() for e
                                           in self.guard_log.events[mark:]])

    # -- introspection / lifecycle ------------------------------------------
    def cache_stats(self) -> dict[str, int]:
        return dict(self._stats, plan_entries=len(self._plan_cache),
                    exec_entries=len(self._exec_cache),
                    calib_entries=len(self._calib_cache))

    def clear_caches(self) -> None:
        """Reset memory tiers + counters (the disk tier stays in place)."""
        self._plan_cache.clear()
        self._exec_cache.clear()
        self._calib_cache.clear()
        for k in self._stats:
            self._stats[k] = 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        c = self.config
        return (f"Session(hw={c.hw.name!r}, alloc={c.alloc_policy!r}, "
                f"order={c.order_policy!r}, autotune={c.autotune}, "
                f"entries={len(self._plan_cache)}p/"
                f"{len(self._exec_cache)}e/{len(self._calib_cache)}c)")


# =========================================================================
# Process-wide default session (backs the legacy api shims)
# =========================================================================

_default_session: Session | None = None
_default_session_lock = threading.Lock()


def default_session() -> Session:
    """The process-wide session the legacy :mod:`repro_torch.core.api` functions
    delegate to.  Created lazily with a default :class:`SessionConfig`.
    Creation is locked: concurrent first callers (a serving fleet's engines
    all defaulting to the shared session) must never observe two distinct
    defaults with split cache state."""
    global _default_session
    if _default_session is None:
        with _default_session_lock:
            if _default_session is None:
                _default_session = Session()
    return _default_session


def reset_default_session(config: SessionConfig | None = None) -> Session:
    """Replace the default session with a fresh one (empty caches, zeroed
    counters).  Tests use this to guarantee cross-test isolation."""
    global _default_session
    with _default_session_lock:
        _default_session = Session(config)
    return _default_session
