"""The port's fault-tolerance control plane against the JAX package's.

``runtime/fault_tolerance.py`` is a copy of the reference's (no framework
code; the trainer uses the heartbeat monitor and the straggler detector).
The five cases of ``tests/test_fault_tolerance.py`` feed the same heartbeat
series on the same injected clock to both packages: the failure detector,
the straggler detector with its escalation, and the elastic controller's
power-of-two mesh plan (survivors required) must give the same verdicts.
"""
import dataclasses

import pytest

from repro.runtime import fault_tolerance as ref_ft
from repro_torch.runtime import fault_tolerance as port_ft

PACKAGES = {"ref": ref_ft, "port": port_ft}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _both(trace):
    out = {k: trace(m) for k, m in PACKAGES.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def test_failure_detector_flags_a_silent_host_as_the_reference():
    def trace(ft):
        clock = FakeClock()
        mon = ft.HeartbeatMonitor([0, 1, 2], clock)
        det = ft.FailureDetector(mon, min_timeout=10.0)
        seen = []
        for _ in range(20):             # everyone beats every second
            clock.advance(1.0)
            for h in (0, 1, 2):
                mon.beat(h)
            det.observe()
            seen.append(det.dead_hosts())
        healthy = det.dead_hosts()
        for _ in range(30):             # host 2 goes silent
            clock.advance(1.0)
            mon.beat(0)
            mon.beat(1)
            det.observe()
            seen.append(det.dead_hosts())
        return (healthy, det.dead_hosts(), mon.hosts[2].alive,
                [mon.hosts[h].alive for h in (0, 1)], seen)

    healthy, dead, alive2, alive01, _ = _both(trace)
    assert healthy == [] and dead == [2]
    assert not alive2 and alive01 == [True, True]


def test_straggler_detection_and_escalation_as_the_reference():
    def trace(ft):
        clock = FakeClock()
        mon = ft.HeartbeatMonitor(list(range(8)), clock)
        det = ft.StragglerDetector(k=3.0, min_samples=8)
        for step in range(16):
            clock.advance(1.0)
            for h in range(8):
                mon.beat(h, step_time=1.0 + (2.5 if h == 7 else 0.0))
        return [det.check(mon) for _ in range(3)]

    d1, _, d3 = _both(trace)
    assert d1 == {7: "rebalance"}
    assert d3 == {7: "evict"}            # the third offence escalates


def test_no_straggler_on_a_uniform_fleet_as_the_reference():
    def trace(ft):
        mon = ft.HeartbeatMonitor(list(range(4)), FakeClock())
        det = ft.StragglerDetector()
        for _ in range(10):
            for h in range(4):
                mon.beat(h, step_time=1.0)
        return det.check(mon)

    assert _both(trace) == {}


@pytest.mark.parametrize("alive", [13, 16, 1, 7])
def test_elastic_controller_plans_a_power_of_two_mesh_as_the_reference(alive):
    def trace(ft):
        plan = ft.ElasticController(hosts_per_pod=16, model_axis=16).plan(
            alive_hosts=list(range(alive)), checkpoint_step=1200)
        return dataclasses.asdict(plan)

    plan = _both(trace)
    rows = 1 << (alive.bit_length() - 1)
    assert plan["mesh_shape"] == (rows, 16)
    assert len(plan["new_hosts"]) == rows
    assert plan["checkpoint_step"] == 1200
    assert sorted(plan["data_partition"].values()) == list(range(rows))


def test_elastic_controller_requires_survivors_as_the_reference():
    for ft in PACKAGES.values():
        with pytest.raises(RuntimeError) as exc:
            ft.ElasticController(16, 16).plan([], None)
        msg = str(exc.value)
    with pytest.raises(RuntimeError, match=msg):
        ref_ft.ElasticController(16, 16).plan([], None)
