"""Spans and counters of the port's own work, off by default.

::

    from repro_torch import trace
    trace.enable()
    model = session.compile(graph, inputs)   # export / compile / record spans
    model(inputs)                            # forward, replay.* spans
    trace.summary()     # {name: {"calls", "host_ns", "self_ns", "device_ns"}}
    trace.records()     # every finished span, in the order they ended
    trace.reset()

A span is a named stretch of host time (``time.perf_counter_ns``) with its
parent span (the innermost span open on the thread when it began) and the
forward it belongs to: a span opened with ``forward=True`` starts a forward
(its own id) and every span inside it carries that id.  Its self time is its
duration less its children's.  A ``device=True`` span also records a pair of
timing ``torch.cuda.Event`` s on the current stream at its ends; their
elapsed time is read once the second has completed, when a later forward
starts or when the records are read, never by waiting on the card: a span
whose events are still pending reads ``device_ns`` None.

While a ``torch.profiler`` session is active, every span is also entered as
a ``torch.profiler.record_function``, so the program's spans land in
kineto's trace on the clock of its device intervals.

Off, a site pays one test of the module flag :data:`on`; hot sites (the
graph replay) branch on it themselves, and :func:`span` hands back one
shared empty context, so nothing is allocated, recorded or synchronised.
``span(..., timed=True)`` measures its duration whether tracing is on or
not (``Session.compile``'s ``timings_ms`` are read from such spans) and is
recorded only when tracing is on.  The records are kept in memory until
:func:`reset`.

A counter (:func:`counter`) is a buffer that the program rewrites on every
forward, on the card inside its recorded graph: the expert-parallel MoE
layer's per-expert routed counts (``moe.held_counts``, registered by the op
graph's export when tracing is on).  A span opened with ``counters=True``
(``replay.device``; the CPU's ``walk``) copies every counter's values into
``Span.counters`` once its work is done: the device span when its end event
is found complete, which in a closed loop is at the next forward's start,
before that forward's replay rewrites the buffer.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Iterable

import torch

on = False          # the one flag every site tests

_records: list["Span"] = []
# (span, start, end events, whether it reads the counters)
_pending: list[tuple["Span", Any, Any, bool]] = []
_counters: dict[str, tuple[torch.Tensor, dict]] = {}
_ids = itertools.count(1)
_local = threading.local()
_NULL = contextlib.nullcontext()


@dataclasses.dataclass(slots=True)
class Span:
    """One finished (or open) span."""

    name: str
    id: int
    parent: int | None
    forward: int | None
    start_ns: int
    end_ns: int = 0
    child_ns: int = 0
    device_ns: int | None = None
    counters: dict[str, list] | None = None

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def self_ns(self) -> int:
        return self.ns - self.child_ns


class _Timer:
    """The context of one span: always times itself; when tracing was on at
    its start, also records a :class:`Span`."""

    __slots__ = ("name", "forward", "device", "counters", "start_ns",
                 "end_ns", "span", "_rf", "_events")

    def __init__(self, name: str, forward: bool, device: bool,
                 counters: bool = False):
        self.name, self.forward, self.device = name, forward, device
        self.counters = counters
        self.span: Span | None = None
        self._rf = self._events = None

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def ms(self) -> float:
        return self.ns / 1e6

    def __enter__(self) -> "_Timer":
        if on:
            stack = _stack()
            outer = stack[-1] if stack else None
            sid = next(_ids)
            if self.forward:
                _resolve()
            fwd = sid if self.forward else (outer.forward if outer else None)
            self.span = Span(self.name, sid, outer.id if outer else None,
                             fwd, 0)
            stack.append(self.span)
            if torch._C._autograd._profiler_enabled():
                self._rf = torch.autograd.profiler.record_function(self.name)
                self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        if self.span is not None and self.device:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._events is not None:
            self._events[1].record()
        self.end_ns = time.perf_counter_ns()
        span = self.span
        if span is None:
            return
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        span.start_ns, span.end_ns = self.start_ns, self.end_ns
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += span.ns
        _records.append(span)
        if self._events is not None:
            _pending.append((span, *self._events, self.counters))
        elif self.counters and _counters:
            span.counters = _read_counters()


def _stack() -> list[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _read_counters() -> dict[str, list]:
    return {name: values.tolist() for name, (values, _) in _counters.items()}


def _resolve() -> None:
    """Device times of the pending spans whose end event has completed, in
    the order they were recorded (a stream runs them in that order), and
    the counters of those that read them."""
    while _pending and _pending[0][2].query():
        span, start, end, counters = _pending.pop(0)
        span.device_ns = round(start.elapsed_time(end) * 1e6)
        if counters and _counters:
            span.counters = _read_counters()


def span(name: str, forward: bool = False, device: bool = False,
         timed: bool = False, counters: bool = False):
    """``with span(name): ...`` records a span when tracing is on.
    ``forward`` starts a forward; ``device`` adds the pair of timing events
    on the current CUDA stream; ``timed`` gives a context whose ``ns`` /
    ``ms`` hold the duration even when tracing is off; ``counters`` copies
    the counters into the span once its work is done."""
    if on or timed:
        return _Timer(name, forward, device, counters)
    return _NULL


def counter(name: str, values: torch.Tensor, **meta: Any) -> None:
    """Register ``values`` as the counter ``name`` (replacing one of that
    name), with ``meta`` beside it (:func:`counter_meta`)."""
    _counters[name] = (values, meta)


def counter_meta() -> dict[str, dict]:
    """The registered counters' ``meta``, by name."""
    return {name: meta for name, (_, meta) in _counters.items()}


def enable(flag: bool = True) -> None:
    """Turn tracing on (or off with ``False``).  Spans already open keep
    their state."""
    global on
    on = bool(flag)


def reset() -> None:
    """Drop every finished record, every pending device time and every
    counter."""
    _records.clear()
    _pending.clear()
    _counters.clear()


def records() -> list[Span]:
    """The finished spans, in the order they ended (a child before its
    parent), device times read where their events have completed."""
    _resolve()
    return list(_records)


def summary(spans: Iterable[Span] | None = None) -> dict[str, dict]:
    """The counters per span name over ``spans`` (default: every record):
    calls, host ns, self ns, and device ns over the calls whose device
    time was read (``device_calls`` of them; None where none was)."""
    out: dict[str, dict] = {}
    for s in records() if spans is None else spans:
        c = out.setdefault(s.name, {"calls": 0, "host_ns": 0, "self_ns": 0,
                                    "device_ns": None, "device_calls": 0})
        c["calls"] += 1
        c["host_ns"] += s.ns
        c["self_ns"] += s.self_ns
        if s.device_ns is not None:
            c["device_ns"] = (c["device_ns"] or 0) + s.device_ns
            c["device_calls"] += 1
    return out
