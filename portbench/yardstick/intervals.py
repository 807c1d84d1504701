"""Interval arithmetic over device kernels: the time any kernel ran, the
time two or more ran at once, and the gaps in which none ran.

Intervals are ``(start, end)`` pairs in one clock.  A frozen copy of the
port's ``chip_smoke.busy_and_overlap``, so that a later change to the
program cannot change how the benchmark reads a trace.
"""
from __future__ import annotations


def busy_and_overlap(intervals) -> tuple[float, float]:
    """The length of the union of ``intervals`` and the length of the part
    of it that two or more of them cover."""
    points = sorted([(a, 1) for a, _ in intervals]
                    + [(b, -1) for _, b in intervals])
    busy = overlap = 0.0
    depth, last = 0, None
    for t, step in points:          # an end sorts before a start at one t
        if depth >= 1:
            busy += t - last
        if depth >= 2:
            overlap += t - last
        depth += step
        last = t
    return busy, overlap


def gaps(intervals, start: float, end: float) -> list[tuple[float, float]]:
    """The stretches of ``[start, end]`` that no interval covers."""
    out = []
    cursor = start
    for a, b in sorted(intervals):
        if a > cursor:
            out.append((cursor, min(a, end)))
        cursor = max(cursor, b)
        if cursor >= end:
            break
    if cursor < end:
        out.append((cursor, end))
    return [(a, b) for a, b in out if b > a]
