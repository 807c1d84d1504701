"""The port's serving tier against the JAX package's.

Both engines serve the overload trace of
``benchmarks/bench_serving.build_trace(n=12, seed=7)`` (two tenants,
priorities, tick deadlines; EDF admission with preemption) on qwen2-0.5b
smoke in fp32, params converted from the JAX init.  Greedy decoding, so the
token streams are exact: fp32 logits agree to 1e-5 (see
``test_torch_model.py``), far inside the gap between the top two tokens of
these streams, and every terminal state, token and counter must be equal.
Sampled streams cannot match (the port draws from a ``torch.Generator``,
the JAX package from ``jax.random`` keys), so only greedy is compared.
"""
import dataclasses
import functools
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from benchmarks.bench_serving import _drive as ref_drive  # noqa: E402
from benchmarks.bench_serving import build_trace  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.runtime.faults import FaultPlan as RefFaultPlan  # noqa: E402
from repro.serving import AdmissionConfig as RefAdmission  # noqa: E402
from repro.serving import InferenceEngine as RefEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import V5E, Session  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.runtime.faults import FaultPlan  # noqa: E402
from repro_torch.serving import (AdmissionConfig, InferenceEngine,  # noqa: E402
                                 Request, RequestState, TERMINAL_STATES,
                                 sample_token)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _models():
    rcfg = dataclasses.replace(ref_config("qwen2-0.5b", smoke=True),
                               dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              dtype=torch.float32)
    ref_model = RefModel(rcfg)
    ref_params = ref_model.init(jax.random.key(0))
    params = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                               "cpu")
    return ref_model, ref_params, cfg, params


def _drive(engine, trace, max_ticks: int = 400):
    """``benchmarks.bench_serving._drive`` with the port's ``Request``."""
    submitted = []
    idx = 0
    while idx < len(trace) or engine._work_pending():
        if engine.tick >= max_ticks:
            break
        while idx < len(trace) and trace[idx]["arrival"] <= engine.tick:
            spec = trace[idx]
            req = Request(rid=spec["rid"], prompt=list(spec["prompt"]),
                          max_tokens=spec["max_tokens"],
                          tenant=spec["tenant"], priority=spec["priority"],
                          ttl=spec["ttl"])
            engine.submit(req)
            submitted.append(req)
            idx += 1
        engine.step()
    engine.drain(max_ticks=max_ticks)
    return submitted


def _terminal_map(done):
    return {r.rid: (r.state.value, tuple(int(t) for t in r.output))
            for r in done}


def _run_pair(paged: bool, use_kernels: bool = False, fault: str | None = None,
              **kw):
    ref_model, ref_params, cfg, params = _models()
    trace = build_trace(n=12, seed=7)
    common = dict(max_slots=2, max_len=64, seed=3, paged_kv=paged,
                  page_size=16, **kw)
    ref = RefEngine(ref_model, ref_params,
                    admission=RefAdmission(policy="edf", preemption=True),
                    fault_plan=RefFaultPlan.parse(fault) if fault else None,
                    **common)
    port = InferenceEngine(Model(cfg, use_kernels=use_kernels), params,
                           admission=AdmissionConfig(policy="edf",
                                                     preemption=True),
                           fault_plan=FaultPlan.parse(fault) if fault else None,
                           **common)
    return (ref, _terminal_map(ref_drive(ref, trace))), \
        (port, _terminal_map(_drive(port, trace)))


@functools.lru_cache(maxsize=None)
def _clean(paged: bool):
    return _run_pair(paged)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_matches_reference_on_overload_trace(paged):
    (ref, ref_done), (port, port_done) = _clean(paged)
    assert port.paged is paged
    assert port_done == ref_done
    assert port.fault_stats == ref.fault_stats
    assert port.tick == ref.tick
    assert port.fault_stats["expired_requests"] >= 1
    assert all(state != "pending" for state, _ in port_done.values())
    if paged:
        assert port.pool.used_pages == 0


def test_paged_equals_dense_inside_the_port():
    dense = _clean(False)[1][1]
    paged = _clean(True)[1][1]
    assert paged == dense


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_kernel_route_engine_matches_plain_route(paged):
    """``use_kernels=True`` (the wrappers' plain versions on the CPU) gives
    the same streams and counters as the plain route."""
    plain = _clean(paged)[1]
    _, (port, done) = _run_pair(paged, use_kernels=True)
    assert done == plain[1]
    assert port.fault_stats == plain[0].fault_stats


def test_decode_step_fault_rung_counted_as_the_reference():
    """A raised ``decode_step`` latches the eager rung and the probation
    rung re-arms the compiled one: the same counters and streams as the
    JAX package's engine (on the CPU the port's compiled rung is its eager
    step, where the fault still fires)."""
    with pytest.warns(UserWarning, match="decode watchdog"):
        (ref, ref_done), (port, port_done) = _run_pair(
            False, fault="decode_step:raise:1", watchdog_probation=2)
    assert port_done == ref_done == _clean(False)[1][1]
    assert port.fault_stats == ref.fault_stats
    assert port.fault_stats["watchdog_fallbacks"] == 1
    assert port.fault_stats["watchdog_probations"] == 1
    assert port._use_compiled


def test_block_table_fault_falls_to_dense_gather_as_the_reference():
    with pytest.warns(UserWarning, match="dense-gather"):
        (ref, ref_done), (port, port_done) = _run_pair(
            True, fault="block_table_build:raise:2")
    assert port_done == ref_done == _clean(True)[1][1]
    assert port.fault_stats == ref.fault_stats
    assert port.fault_stats["block_table_faults"] == 2
    assert port.fault_stats["paged_decode_fallbacks"] == 2


def test_corrupt_decode_step_fails_one_slot_as_the_reference():
    (ref, ref_done), (port, port_done) = _run_pair(
        False, fault="decode_step:corrupt:1:1")
    assert port_done == ref_done
    assert port.fault_stats == ref.fault_stats
    assert port.fault_stats["failed_requests"] == 1


def test_paged_resume_skips_reprefill():
    """A preempted paged request keeps its pages and resumes without
    re-prefilling; the dense engine re-runs the whole prefix; both emit
    the same tokens and counters as the JAX package's engines."""
    from repro.serving import Request as RefRequest
    ref_model, ref_params, cfg, params = _models()

    def run(paged, ref=False):
        engine_cls, request, admission = (
            (RefEngine, RefRequest, RefAdmission) if ref else
            (InferenceEngine, Request, AdmissionConfig))
        engine = engine_cls(
            ref_model if ref else Model(cfg), ref_params if ref else params,
            max_slots=1, max_len=32, seed=5,
            admission=admission(policy="edf", preemption=True),
            paged_kv=paged, page_size=4)
        engine.submit(request(rid="low", prompt=[5, 6, 7], max_tokens=12))
        for _ in range(4):
            engine.step()
        engine.submit(request(rid="hi", prompt=[9, 9], max_tokens=3,
                              priority=3, ttl=4))
        return engine, _terminal_map(engine.run(200))

    dense_engine, dense = run(False)
    paged_engine, paged = run(True)
    for engine, done, paged_kv in ((dense_engine, dense, False),
                                   (paged_engine, paged, True)):
        ref_engine, ref_done = run(paged_kv, ref=True)
        assert done == ref_done
        assert engine.fault_stats == ref_engine.fault_stats
    assert paged == dense
    assert paged_engine.fault_stats["preemptions"] == 1
    assert dense_engine.fault_stats["reprefilled_tokens"] > 0
    assert paged_engine.fault_stats["reprefilled_tokens"] == 0
    assert paged_engine.fault_stats["page_resumes"] == 1
    assert paged_engine.pool.used_pages == 0


def test_every_request_goes_terminal_and_oversized_prompts_fail():
    _, _, cfg, params = _models()
    engine = InferenceEngine(Model(cfg), params, max_slots=2, max_len=16)
    reqs = [Request(rid=i, prompt=[1, 2, 3 + i], max_tokens=4)
            for i in range(3)]
    reqs.append(Request(rid="big", prompt=list(range(1, 20)), max_tokens=2))
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    assert len(done) == 4 and all(r.state in TERMINAL_STATES for r in reqs)
    assert reqs[-1].state is RequestState.FAILED
    assert all(len(r.output) == 4 for r in reqs[:3])
    assert engine.kv_cache_bytes() == 2 * cfg.n_layers * 2 * 16 * \
        cfg.n_kv_heads * cfg.head_dim * 4


def test_calibrate_schedule_on_the_port_session():
    _, _, cfg, params = _models()
    engine = InferenceEngine(Model(cfg), params, max_slots=2, max_len=32,
                             session=Session(device="cpu", hw=V5E))
    plan = engine.calibrate_schedule(n_layers=2)
    assert plan is engine.schedule_plan
    assert all(n.cost.measured_us is not None
               for n in plan.graph if n.fn is not None)


def test_sampler_modes():
    logits = torch.tensor([[0.0, 5.0, 1.0, -2.0]])
    g = torch.Generator().manual_seed(0)
    assert int(sample_token(logits)[0]) == 1                   # greedy
    assert int(sample_token(logits, g, temperature=1.0, top_k=2)[0]) in (1, 2)
    assert int(sample_token(logits, g, temperature=1.0, top_p=0.5)[0]) == 1
    draws = [int(sample_token(logits, torch.Generator().manual_seed(s),
                              temperature=5.0)[0]) for s in range(40)]
    assert len(set(draws)) > 1                                 # it samples
    again = [int(sample_token(logits, torch.Generator().manual_seed(s),
                              temperature=5.0)[0]) for s in range(40)]
    assert draws == again                                      # seeded


@pytest.mark.parametrize("name", ["admission.py", "kv_pool.py"])
def test_copied_serving_modules_stay_copies(name):
    """The pure-Python admission tier and page pool are copies of the JAX
    package's; only the docstring's provenance note differs."""
    ours = (ROOT / "src/repro_torch/serving" / name).read_text().splitlines()
    theirs = (ROOT / "src/repro/serving" / name).read_text().splitlines()
    note = [i for i, line in enumerate(ours) if "A copy of the JAX" in line]
    assert len(note) == 1
    del ours[note[0] - 1:note[0] + 1]
    assert ours == theirs
