"""The serving engine's fault sites against the JAX package's engine.

Each scenario of ``scripts/torch_chaos_smoke.py`` that drives the engine —
the burst trace (7 requests, 2 slots, ``max_queue=3``, ``tenant_quota=2``,
three tenants, mixed priorities and deadlines), the one-slot preemption
trace, the paged burst trace (4-position pages) and the co-batch of three —
runs with the same fault spec on both packages' engines, over
Llama-3.2-1B's smoke model in fp32 with the reference's params bridged into
the port.  Every request's terminal state and output tokens, the whole
``fault_stats`` dict (``by_tenant`` included; dict equality ignores its
order), the tick count and the page pool's books must be equal; then the
port's faulted run is held against its own fault-free run, as the script
does (``test_torch_page_faults.py`` faults the page sites at each of their
activations in turn).  Greedy decoding: fp32 logits agree
to 1e-5 (``test_torch_model.py``), far inside these streams' top-2 gaps,
so tokens must be exact.
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import serving as ref_serving  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.runtime import faults as ref_faults  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as port_serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.runtime import faults as port_faults  # noqa: E402

from test_torch_chaos_smoke import chaos  # noqa: E402

SHAPE = chaos.TraceShape()             # the JAX script's sizes


@functools.lru_cache(maxsize=None)
def _models():
    rcfg = dataclasses.replace(ref_config("llama3.2-1b", smoke=True),
                               dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              dtype=torch.float32)
    ref_model = RefModel(rcfg)
    ref_params = ref_model.init(jax.random.key(0))
    params = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                               "cpu")
    return ref_model, ref_params, Model(cfg, use_kernels=True), params


def _terminal(done: dict) -> dict:
    return {rid: (r.state.value, tuple(int(t) for t in r.output))
            for rid, r in done.items()}


def _pool(engine):
    if engine.pool is None:
        return None
    return (engine.pool.used_pages, engine.pool.free_pages,
            dict(engine.pool.stats))


def _run(pkg: str, trace, plan=None, **kw):
    ref_model, ref_params, model, params = _models()
    api, m, p = ((ref_serving, ref_model, ref_params) if pkg == "ref"
                 else (port_serving, model, params))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        engine, done = trace(api, m, p, SHAPE, fault_plan=plan, **kw)
    return engine, done


def _pair(trace, spec=None, make_plan=None, **kw):
    """The same trace and fault on both engines; asserts they agree and
    returns the port's (engine, done)."""
    plans = {"ref": None, "port": None}
    if spec is not None:
        plans = {"ref": ref_faults.FaultPlan.parse(spec),
                 "port": port_faults.FaultPlan.parse(spec)}
    if make_plan is not None:
        plans = {"ref": make_plan(ref_faults), "port": make_plan(port_faults)}
    ref, ref_done = _run("ref", trace, plans["ref"], **kw)
    port, port_done = _run("port", trace, plans["port"], **kw)
    assert _terminal(port_done) == _terminal(ref_done)
    assert port.fault_stats == ref.fault_stats
    assert port.tick == ref.tick
    assert _pool(port) == _pool(ref)
    for r in port_done.values():
        same = ref_done[r.rid]
        assert (r.error is None) == (same.error is None)
        assert r.preemptions == same.preemptions
    return port, port_done


@functools.lru_cache(maxsize=None)
def _clean(trace_name: str):
    return _pair(chaos.TRACES[trace_name])


@pytest.mark.parametrize("trace", sorted(chaos.TRACES))
def test_fault_free_traces_match_the_reference(trace):
    engine, done = _clean(trace)
    chaos.check_all_terminal(engine, done, "none")
    assert not any(engine.fault_stats[c]
                   for c in chaos.SITE_COUNTER.values())


def test_corrupt_decode_step_fails_one_request_as_the_reference():
    engine, done = _pair(chaos.decode_batch_run, "decode_step:corrupt:1:0")
    clean = _clean("decode_batch")[1]
    states = [r.state for r in done.values()]
    assert states.count(port_serving.RequestState.FAILED) == 1
    assert "non-finite" in done[0].error
    assert engine.fault_stats["failed_requests"] == 1
    assert chaos.check_done_streams(done, clean, "decode_step") == 2


def test_decode_watchdog_and_probation_as_the_reference():
    engine, done = _pair(chaos.decode_batch_run, "decode_step:raise:1",
                         watchdog_probation=2)
    clean = _clean("decode_batch")[1]
    assert engine.fault_stats["watchdog_fallbacks"] == 1
    assert engine.fault_stats["watchdog_probations"] == 1
    assert engine._use_compiled
    assert chaos.check_done_streams(done, clean, "decode_step") == 3


@pytest.mark.parametrize("spec", ["admission_enqueue:raise:2",
                                  "admission_enqueue:raise:-1",
                                  "deadline_check:raise:-1",
                                  "deadline_check:raise:3"])
def test_overload_sites_as_the_reference(spec):
    site = spec.split(":")[0]
    engine, done = _pair(chaos.overload_run, spec)
    clean = _clean("overload")[1]
    chaos.check_all_terminal(engine, done, site)
    counter = chaos.SITE_COUNTER[site]
    assert engine.fault_stats[counter] >= 1
    chaos.check_no_foreign_failure(done, clean, site)
    chaos.check_done_streams(done, clean, site)
    if site == "admission_enqueue":
        shed = [r for r in done.values()
                if r.error == f"injected fault at site {site!r}"]
        assert len(shed) == engine.fault_stats[counter]
        assert all(r.state is port_serving.RequestState.SHED for r in shed)


def test_slot_preempt_fault_skips_the_preemption_as_the_reference():
    engine, done = _pair(chaos.preempt_run, "slot_preempt:raise:-1")
    clean = _clean("preempt")[1]
    assert clean[1].state is port_serving.RequestState.DONE
    assert clean[0].preemptions == 1
    assert engine.fault_stats["preempt_faults"] >= 1
    assert done[0].state is port_serving.RequestState.DONE
    assert done[0].output == clean[0].output
    assert done[1].state is port_serving.RequestState.EXPIRED
    chaos.check_all_terminal(engine, done, "slot_preempt")


@pytest.mark.parametrize("spec", ["page_alloc:raise:2", "page_alloc:raise:-1",
                                  "page_release:raise:1",
                                  "page_release:raise:-1",
                                  "block_table_build:raise:1"])
def test_paged_sites_as_the_reference(spec):
    site = spec.split(":")[0]
    engine, done = _pair(chaos.paged_run, spec)
    clean = _clean("paged")[1]
    chaos.check_all_terminal(engine, done, site)
    assert engine.fault_stats[chaos.SITE_COUNTER[site]] >= 1
    chaos.check_no_foreign_failure(done, clean, site)
    chaos.check_done_streams(done, clean, site)
    leaked = chaos.check_pool_books(engine, site)
    if site == "page_release":
        assert leaked >= 1
        assert engine.health()["paged"]["leaked_pages"] == leaked
    else:
        assert leaked == 0
