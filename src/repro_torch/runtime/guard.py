"""Graceful-degradation primitives: the fallback-chain bookkeeping of the
session (``core/session.py``).  A copy of the JAX package's
``runtime/guard.py`` without its kernel-fallback log: in this package a
kernel wrapper launches its kernel or raises, so it has nothing to log.

The session keeps two slower-but-correct rungs: calibration degrades from
measured to analytic costs, and a corrupt plan is re-scheduled sequential.
A degradation is never silent — each one is recorded as a structured
:class:`Degradation` event (surfaced through
``CompiledModel.explain()["degraded"]`` and ``Session.cache_stats()``) and
announced once via a :class:`DegradationWarning`.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable


class DegradationWarning(UserWarning):
    """Category for "we kept serving, but on a slower path" warnings, so
    deployments can route them to structured logs (and tests can assert on
    exactly one being emitted)."""


@dataclasses.dataclass(frozen=True)
class Degradation:
    """One recorded fallback: which ladder site tripped, what the recovery
    action was (``from->to``), and why."""

    site: str
    action: str
    reason: str

    def as_dict(self) -> dict[str, str]:
        return dataclasses.asdict(self)


class DegradationLog:
    """Append-only event list with counters — cheap enough to attach to
    every ``CapturedGraph`` / ``Session`` unconditionally."""

    def __init__(self) -> None:
        self.events: list[Degradation] = []

    def note(self, site: str, action: str, reason: str,
             warn: bool = False) -> Degradation:
        d = Degradation(site=site, action=action, reason=reason)
        self.events.append(d)
        if warn:
            warnings.warn(
                f"degraded [{site}] {action}: {reason}", DegradationWarning,
                stacklevel=3)
        return d

    def count(self, site: str | None = None) -> int:
        if site is None:
            return len(self.events)
        return sum(1 for e in self.events if e.site == site)

    def extend(self, other: "DegradationLog") -> None:
        self.events.extend(other.events)

    def as_dicts(self) -> list[dict[str, str]]:
        return [e.as_dict() for e in self.events]

    def __len__(self) -> int:
        return len(self.events)


def retry_with_backoff(
    fn: Callable[[], Any],
    retries: int = 2,
    base_delay_s: float = 0.0,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Callable[[int, BaseException], None] | None = None,
) -> Any:
    """Run ``fn`` with up to ``retries`` retries and doubling backoff.

    Bounded and clock-injectable: ``sleep`` defaults to ``time.sleep`` but
    tests (and the default ``SessionConfig.calib_backoff_s=0``) keep it a
    no-op, so retry behavior is deterministic.  ``on_retry(attempt, exc)``
    fires before each re-attempt (the caller's counter hook).  The last
    failure propagates unchanged once the budget is exhausted — the caller
    owns the next rung of the ladder.
    """
    delay = base_delay_s
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as exc:
            if attempt == retries:
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            if delay > 0:
                sleep(delay)
                delay *= 2
