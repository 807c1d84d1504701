"""Legacy module-function Opara API (shims over :mod:`repro_torch.core.session`).

.. deprecated::
    New code should construct a :class:`repro_torch.core.Session`::

        from repro_torch.core import Session, SessionConfig

        sess = Session(SessionConfig(autotune=True))
        model = sess.compile(graph, inputs=profiling_inputs)
        outs = model({"tokens": x})

A copy of the JAX package's ``core/api.py``.  The default session is a
CUDA session, so on a host without a card these shims raise; CPU callers
construct ``Session(device="cpu", hw=...)`` themselves.

Historically this module owned the whole pipeline behind three functions
(``plan`` / ``optimize`` / ``calibrate``) whose kwargs grew into a
cross-product (``alloc_policy``, ``order_policy``, ``hw``, ``sim_cfg``,
``autotune``, ``weights_key``, ``load``, …) backed by three process-global
LRU caches.  That state now lives on :class:`repro_torch.core.session.Session`;
the functions below delegate to the process-wide
:func:`repro_torch.core.session.default_session` — so existing callers keep the
exact same caching/amortization behavior — and emit ``DeprecationWarning``
when passed the superseded configuration kwargs (per-call data such as
``measured_inputs``, ``repeats``, ``output_ids`` and ``cache`` stays
warning-free: those remain arguments on the ``Session`` methods too).

``cache_stats()`` / ``clear_caches()`` report on and reset the default
session only; explicitly-constructed sessions are isolated and unaffected.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Mapping

from .capture import CapturedGraph
from .graph import OpGraph
from .profiler import HardwareSpec, ProfileTable
from .scheduler import SchedulePlan
from .simulator import SimConfig
from .session import (
    Session,
    SessionConfig,
    calibration_key,
    default_session,
    graph_signature,
)

__all__ = [
    "cache_stats", "calibrate", "calibration_key", "clear_caches",
    "graph_signature", "optimize", "plan",
]

# Sentinel distinguishing "kwarg not passed" from an explicit default value:
# only explicitly-passed config kwargs trigger the deprecation path.
_UNSET: Any = object()

# legacy kwarg spelling → SessionConfig field (where they differ)
_CONFIG_FIELD = {"load": "load_calibration"}


def _effective(fn_name: str, **overrides: Any) -> tuple[Session, SessionConfig]:
    """Resolve the default session + a per-call config with any explicitly
    passed legacy kwargs applied (warning once per call site)."""
    sess = default_session()
    passed = {k: v for k, v in overrides.items() if v is not _UNSET}
    if passed:
        warnings.warn(
            f"passing {sorted(passed)} to repro_torch.core.api.{fn_name}() "
            "is deprecated; construct a "
            "repro_torch.core.Session(SessionConfig(...)) instead",
            DeprecationWarning, stacklevel=3)
        cfg_kwargs = {_CONFIG_FIELD.get(k, k): v for k, v in passed.items()}
        return sess, dataclasses.replace(sess.config, **cfg_kwargs)
    return sess, sess.config


def calibrate(
    graph: OpGraph,
    inputs: Mapping[int, Any],
    hw: HardwareSpec = _UNSET,
    repeats: int | None = None,
    load: bool | None = None,
) -> ProfileTable:
    """Deprecated shim for :meth:`Session.calibrate` on the default session.

    ``repeats`` / ``load`` left unset defer to the session config
    (``calibration_repeats`` / ``load_calibration``), exactly like
    :meth:`Session.calibrate`."""
    sess, cfg = _effective("calibrate", hw=hw)
    table, _ = sess._calibrate(graph, inputs, cfg, repeats=repeats, load=load)
    return table


def plan(
    graph: OpGraph,
    alloc_policy: str = _UNSET,
    order_policy: str = _UNSET,
    hw: HardwareSpec = _UNSET,
    measured_inputs: Mapping[int, Any] | None = None,
    cache: bool = True,
    autotune: bool = _UNSET,
    sim_cfg: SimConfig | None = _UNSET,
    load: bool = _UNSET,
) -> SchedulePlan:
    """Deprecated shim for :meth:`Session.plan` on the default session."""
    sess, cfg = _effective(
        "plan", alloc_policy=alloc_policy, order_policy=order_policy, hw=hw,
        autotune=autotune, sim_cfg=sim_cfg, load=load)
    p, _ = sess._plan(graph, cfg, measured_inputs=measured_inputs,
                      cache=cache)
    return p


def optimize(
    graph: OpGraph,
    alloc_policy: str = _UNSET,
    order_policy: str = _UNSET,
    hw: HardwareSpec = _UNSET,
    output_ids=None,
    gemm_kernel: str = _UNSET,
    cache: bool = True,
    weights_key: str = _UNSET,
    autotune: bool = _UNSET,
    sim_cfg: SimConfig | None = _UNSET,
) -> CapturedGraph:
    """Deprecated shim for :meth:`Session.optimize` on the default session."""
    sess, cfg = _effective(
        "optimize", alloc_policy=alloc_policy, order_policy=order_policy,
        hw=hw, gemm_kernel=gemm_kernel, weights_key=weights_key,
        autotune=autotune, sim_cfg=sim_cfg)
    p, _ = sess._plan(graph, cfg, cache=cache)
    exe, _ = sess._capture(graph, cfg, p, output_ids=output_ids, cache=cache)
    return exe


def cache_stats() -> dict[str, int]:
    """Hit/miss counters + entry counts of the DEFAULT session's caches."""
    return default_session().cache_stats()


def clear_caches() -> None:
    """Reset the DEFAULT session's memory tiers and counters."""
    default_session().clear_caches()
