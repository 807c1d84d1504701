"""Fault tolerance primitives for 1000+-node runs.

A copy of the JAX package's ``runtime/fault_tolerance.py`` (no framework
code).

Deterministic, dependency-free implementations of the control-plane logic
(the data plane — checkpoint/restore — lives in repro_torch.checkpoint):

  * :class:`HeartbeatMonitor` — per-host liveness ledger;
  * :class:`FailureDetector`  — ϕ-accrual-lite detector over heartbeat gaps;
  * :class:`StragglerDetector`— step-time outlier detection (μ+kσ) with a
    mitigation decision (rebalance data / evict host);
  * :class:`ElasticController` — failure → new mesh shape → restore plan
    (which checkpoint, how to re-partition data, new mesh axes).

All classes take explicit clocks so tests drive them deterministically.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Callable


@dataclasses.dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    step_times: list[float] = dataclasses.field(default_factory=list)
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, hosts: list[int], now: Callable[[], float]):
        self._now = now
        self.hosts = {h: HostState(h, now()) for h in hosts}

    def beat(self, host_id: int, step_time: float | None = None) -> None:
        st = self.hosts[host_id]
        st.last_heartbeat = self._now()
        if step_time is not None:
            st.step_times.append(step_time)
            if len(st.step_times) > 64:
                st.step_times.pop(0)

    def silence(self, host_id: int) -> float:
        return self._now() - self.hosts[host_id].last_heartbeat


class FailureDetector:
    """Declare a host dead when its heartbeat gap exceeds
    mean + k·stdev of its own recent gaps (ϕ-accrual simplification),
    floored at ``min_timeout``."""

    def __init__(self, monitor: HeartbeatMonitor, k: float = 6.0,
                 min_timeout: float = 30.0):
        self.monitor = monitor
        self.k = k
        self.min_timeout = min_timeout
        self._gaps: dict[int, list[float]] = {h: [] for h in monitor.hosts}
        self._last: dict[int, float] = {
            h: st.last_heartbeat for h, st in monitor.hosts.items()}

    def observe(self) -> None:
        for h, st in self.monitor.hosts.items():
            if st.last_heartbeat > self._last[h]:
                self._gaps[h].append(st.last_heartbeat - self._last[h])
                self._last[h] = st.last_heartbeat
                if len(self._gaps[h]) > 128:
                    self._gaps[h].pop(0)

    def dead_hosts(self) -> list[int]:
        out = []
        for h, st in self.monitor.hosts.items():
            if not st.alive:
                out.append(h)
                continue
            gaps = self._gaps[h]
            mu = statistics.mean(gaps) if gaps else self.min_timeout
            sd = statistics.pstdev(gaps) if len(gaps) > 1 else mu / 2
            threshold = max(self.min_timeout, mu + self.k * sd)
            if self.monitor.silence(h) > threshold:
                st.alive = False
                out.append(h)
        return out


class StragglerDetector:
    """Flag hosts whose recent mean step time exceeds the fleet median by
    k robust deviations (median/MAD — a straggler must not inflate its own
    threshold, which μ/σ statistics allow).

    Mitigation ladder (returned as the decision string):
      1 "rebalance"  — shave the straggler's data shard (first offence);
      2 "evict"      — treat as failed → elastic rescale (repeat offender).
    """

    def __init__(self, k: float = 3.0, min_samples: int = 8,
                 min_rel_dev: float = 0.05):
        self.k = k
        self.min_samples = min_samples
        self.min_rel_dev = min_rel_dev
        self.offences: dict[int, int] = {}

    def check(self, monitor: HeartbeatMonitor) -> dict[int, str]:
        means = {}
        for h, st in monitor.hosts.items():
            if st.alive and len(st.step_times) >= self.min_samples:
                means[h] = statistics.mean(st.step_times[-self.min_samples:])
        if len(means) < 3:
            return {}
        med = statistics.median(means.values())
        mad = statistics.median(abs(m - med) for m in means.values())
        dev = max(1.4826 * mad, self.min_rel_dev * med, 1e-9)
        decisions = {}
        for h, m in means.items():
            if m > med + self.k * dev:
                n = self.offences.get(h, 0) + 1
                self.offences[h] = n
                decisions[h] = "rebalance" if n < 3 else "evict"
        return decisions


@dataclasses.dataclass
class RestorePlan:
    checkpoint_step: int | None
    new_hosts: list[int]
    mesh_shape: tuple[int, ...]
    data_partition: dict[int, int]   # host_id -> data shard index


class ElasticController:
    """Failure → new topology decision.

    Given the surviving hosts and the per-pod geometry, pick the largest
    (data × model) mesh that the survivors can form (model axis preserved —
    TP degree is baked into the compiled program; data axis shrinks), and
    emit a restore plan pointing at the newest durable checkpoint.
    """

    def __init__(self, hosts_per_pod: int, model_axis: int):
        self.hosts_per_pod = hosts_per_pod
        self.model_axis = model_axis

    def plan(self, alive_hosts: list[int], checkpoint_step: int | None) -> RestorePlan:
        alive = sorted(alive_hosts)
        if not alive:
            raise RuntimeError("no survivors — cannot form any mesh")
        # keep whole model-parallel groups only
        usable = len(alive)
        data_axis = max(1, usable)  # hosts map 1:1 to data-parallel rows here
        # power-of-two data axis keeps collectives ring-friendly
        data_axis = 2 ** int(math.log2(data_axis))
        hosts = alive[:data_axis]
        return RestorePlan(
            checkpoint_step=checkpoint_step,
            new_hosts=hosts,
            mesh_shape=(data_axis, self.model_axis),
            data_partition={h: i for i, h in enumerate(hosts)},
        )
