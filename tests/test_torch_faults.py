"""The port's fault layer against the JAX package's.

``runtime/faults.py`` (spec validation, the ``site:mode[:times[:arg]]``
grammar, firing and disarming, the three modes, process-wide activation)
and ``runtime/guard.py`` (retry with doubling backoff, the degradation log)
are driven with the same specs, payloads, clocks and failures in both
packages (numpy is the bridge for tensor payloads).  The Session's sites —
``calibration_measure``, ``calib_disk_read``, ``calib_disk_write``,
``plan_validate`` — run on the same graph, built in both packages from one
numpy seed, and their counters, provenance, events and outputs must be
equal.  The fused-route sites (``kernel_compile``, ``grouped_gemm_route``)
and the call-time rule are held to ROADMAP C28: where the JAX package
degrades to a slower rung, the port raises.  Both packages are armed with
explicit ``FaultPlan`` objects (their environment variables differ by
design: ``REPRO_TORCH_FAULT_PLAN`` against ``REPRO_FAULT_PLAN``).
Tolerance: fp32 1e-5.
"""
import contextlib
import dataclasses
import json
import os
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import Session as RefSession  # noqa: E402
from repro.core import run_sequential_uncompiled as ref_sequential  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.core import profiler as ref_profiler  # noqa: E402
from repro.core import session as ref_session  # noqa: E402
from repro.core.profiler import ModelProfiler as RefProfiler  # noqa: E402
from repro.core.profiler import ProfileTable as RefTable  # noqa: E402
from repro.runtime import faults as ref_faults  # noqa: E402
from repro.runtime import guard as ref_guard  # noqa: E402
from repro_torch.core import V5E, Session  # noqa: E402
from repro_torch.core import session as port_session  # noqa: E402
from repro_torch.core.capture import run_sequential_uncompiled  # noqa: E402
from repro_torch.core import graph as port_graph  # noqa: E402
from repro_torch.core import profiler as port_profiler  # noqa: E402
from repro_torch.core.graph import OpGraph, OpKind  # noqa: E402
from repro_torch.core.profiler import ModelProfiler, ProfileTable  # noqa: E402
from repro_torch.runtime import faults  # noqa: E402
from repro_torch.runtime import guard  # noqa: E402
from repro_torch.runtime.faults import FaultInjected, FaultPlan, FaultSpec  # noqa: E402

from conftest import build_inception_like  # noqa: E402


# -- graphs, built in both packages from one seed -------------------------------

def _mm(x, w):
    return x @ w


def _sum(*xs):
    return sum(xs)


def _port_inception(n_blocks=3, width=4, d=64, tokens=8, seed=0):
    """``conftest.build_inception_like`` in the port (the same rng order)."""
    rng = np.random.default_rng(seed)
    g = OpGraph("incep")
    cur = g.add("x", OpKind.INPUT, out_shape=(tokens, d))
    for blk in range(n_blocks):
        outs = []
        for b in range(width):
            w = torch.tensor(rng.standard_normal((d, d)) * 0.05,
                             dtype=torch.float32)
            c = g.add(f"b{blk}_{b}_gemm", OpKind.GEMM, [cur], fn=_mm,
                      cost=port_profiler.gemm_cost(tokens, d, d, 4),
                      fuse_sig=("gemm", tokens, d, d), consts=(w,),
                      payload="matmul")
            outs.append(g.add(
                f"b{blk}_{b}_relu", OpKind.ELEMENTWISE, [c], fn=torch.relu,
                cost=port_profiler.elementwise_cost(tokens * d, 4),
                fuse_sig=("relu", tokens, d)))
        cur = g.add(f"b{blk}_sum", OpKind.ELEMENTWISE, outs, fn=_sum,
                    cost=port_profiler.elementwise_cost(tokens * d, 4,
                                                        n_in=width))
    g.validate()
    return g


def _pair(n_blocks=2, width=3, seed=0):
    return (build_inception_like(n_blocks=n_blocks, width=width, seed=seed),
            _port_inception(n_blocks=n_blocks, width=width, seed=seed))


def _ragged(graph_mod, profiler_mod, tensor, sizes=(8, 24, 16), k=128,
            f=128, seed=3):
    rng = np.random.default_rng(seed)
    g = graph_mod.OpGraph("ragged")
    for i, m in enumerate(sizes):
        x = g.add(f"x{i}", graph_mod.OpKind.INPUT, out_shape=(m, k))
        g.add(f"gemm{i}", graph_mod.OpKind.GEMM, [x], fn=_mm,
              cost=profiler_mod.gemm_cost(m, k, f, 4), fuse_sig=("gemm", k, f),
              consts=(tensor(rng.standard_normal((k, f)) * 0.05),),
              payload="matmul", out_shape=(m, f))
    g.validate()
    return g


def _ragged_pair():
    return (_ragged(ref_graph, ref_profiler,
                    lambda a: jnp.asarray(a, jnp.float32)),
            _ragged(port_graph, port_profiler,
                    lambda a: torch.tensor(a, dtype=torch.float32)))


def _x(seed=0, shape=(8, 64)):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(
        np.float32)


def _inputs_np(g, seed=9):
    rng = np.random.default_rng(seed)
    return {n.name: (rng.standard_normal(n.out_shape) * 0.1).astype(np.float32)
            for n in g if n.fn is None}


def _sessions(tmp_path, **kw):
    """A reference Session and a port Session (CPU, the reference's V5E
    spec) on disk tiers of their own."""
    ref = RefSession(calib_dir=str(tmp_path / "ref"), **{
        k: (_ref_plan(v) if k == "fault_plan" else v) for k, v in kw.items()})
    port = Session(device="cpu", hw=V5E, calib_dir=str(tmp_path / "port"),
                   **kw)
    return ref, port


def _ref_plan(plan: FaultPlan):
    return ref_faults.FaultPlan([ref_faults.FaultSpec(**dataclasses.asdict(s))
                                 for s in plan.specs.values()])


def _calib(g, x):
    return {n.op_id: x for n in g if n.fn is None}


@contextlib.contextmanager
def count_measures():
    """Count profiling inferences in both packages."""
    calls = {"ref": 0, "port": 0}
    patched = []
    for key, cls in (("ref", RefProfiler), ("port", ModelProfiler)):
        orig = cls.measure

        def counting(self, graph, inputs, repeats=3, _orig=orig, _key=key):
            calls[_key] += 1
            return _orig(self, graph, inputs, repeats=repeats)

        cls.measure = counting
        patched.append((cls, orig))
    try:
        yield calls
    finally:
        for cls, orig in patched:
            cls.measure = orig


def _assert_outputs(port_outs, ref_outs, tol=1e-5):
    assert len(port_outs) == len(ref_outs)
    for a, b in zip(port_outs, ref_outs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol)


# -- runtime/faults.py ------------------------------------------------------------

def test_sites_and_modes_match_the_reference():
    assert faults.SITES == ref_faults.SITES
    assert faults.MODES == ref_faults.MODES
    assert len(faults.SITES) == 13
    assert faults.ENV_VAR == "REPRO_TORCH_FAULT_PLAN"


@pytest.mark.parametrize("make", [
    lambda m: m.FaultSpec(site="bogus"),
    lambda m: m.FaultSpec(site="decode_step", mode="bogus"),
    lambda m: m.FaultPlan([m.FaultSpec(site="decode_step"),
                           m.FaultSpec(site="decode_step")]),
], ids=["site", "mode", "duplicate"])
def test_spec_validation_raises_as_the_reference(make):
    with pytest.raises(ValueError) as port_exc:
        make(faults)
    with pytest.raises(ValueError) as ref_exc:
        make(ref_faults)
    assert str(port_exc.value) == str(ref_exc.value)


@pytest.mark.parametrize("text", [
    "calibration_measure:raise:2; decode_step:corrupt:-1:3,plan_validate",
    "page_alloc:raise:2",
    "decode_step:corrupt:1:0",
    "calibration_measure:delay:1:0.25",
    " ; ,kernel_compile::3",
    "block_table_build:raise, page_release:raise:1",
    "",
])
def test_plan_grammar_parses_as_the_reference(text):
    port, ref = faults.FaultPlan.parse(text), ref_faults.FaultPlan.parse(text)
    assert {s: dataclasses.asdict(v) for s, v in port.specs.items()} == \
        {s: dataclasses.asdict(v) for s, v in ref.specs.items()}
    assert port.describe() == ref.describe()


@pytest.mark.parametrize("text", ["bogus", "decode_step:explode",
                                  "decode_step:raise:x",
                                  "decode_step:raise:1:y",
                                  "decode_step;decode_step:corrupt"])
def test_bad_plan_text_raises_as_the_reference(text):
    with pytest.raises(ValueError) as port_exc:
        faults.FaultPlan.parse(text)
    with pytest.raises(ValueError) as ref_exc:
        ref_faults.FaultPlan.parse(text)
    assert str(port_exc.value) == str(ref_exc.value)


def _fire_trace(mod, plan):
    """Fire a fixed sequence of sites; record what each activation did."""
    out = []
    for site in ("kernel_compile", "kernel_compile", "decode_step",
                 "page_alloc", "page_alloc", "page_alloc", "page_release",
                 "calib_disk_write", "calib_disk_write"):
        try:
            got = plan.fire(site, payload="p")
            out.append((site, "passed", got))
        except mod.FaultInjected as exc:
            out.append((site, "raised", exc.site, str(exc)))
    return out, dict(plan.fired), dict(plan.activations), plan.describe()


def test_firing_counts_and_disarms_as_the_reference():
    text = ("kernel_compile:raise:1;page_alloc:raise:2;"
            "calib_disk_write:corrupt:-1;page_release:delay:1:0.5")
    port = _fire_trace(faults, faults.FaultPlan.parse(text))
    ref = _fire_trace(ref_faults, ref_faults.FaultPlan.parse(text))
    assert port == ref
    assert port[1] == {"kernel_compile": 1, "page_alloc": 2,
                       "calib_disk_write": 2, "page_release": 1}
    single = faults.FaultPlan.single("kernel_compile", times=1)
    assert single.armed("kernel_compile")
    with pytest.raises(FaultInjected):
        single.fire("kernel_compile")
    assert not single.armed("kernel_compile")
    assert not single.armed("decode_step")


@pytest.mark.parametrize("payload", ['{"key": "v"}', b"\x01\x02\x03\x04",
                                     bytearray(b"abc"), 5, None, "x"],
                         ids=["str", "bytes", "bytearray", "int", "none",
                              "short"])
def test_corrupt_mode_mangles_as_the_reference(payload):
    got = faults.FaultPlan.single("calib_disk_write", mode="corrupt",
                                  times=-1).fire("calib_disk_write", payload)
    want = ref_faults.FaultPlan.single("calib_disk_write", mode="corrupt",
                                       times=-1).fire("calib_disk_write",
                                                      payload)
    assert got == want
    if isinstance(payload, str):
        with pytest.raises(ValueError):
            json.loads(got)


@pytest.mark.parametrize("row", [0, 1, 2])
def test_corrupt_mode_poisons_one_tensor_row_of_a_copy(row):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = torch.from_numpy(a.copy())
    got = faults.FaultPlan.single("decode_step", mode="corrupt", times=-1,
                                  arg=row).fire("decode_step", t)
    want = np.asarray(ref_faults.FaultPlan.single(
        "decode_step", mode="corrupt", times=-1, arg=row).fire(
            "decode_step", jnp.asarray(a)))
    assert got is not t and torch.equal(t, torch.from_numpy(a))
    np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(want))
    assert list(np.isfinite(want).all(axis=-1)) == [r != row for r in range(3)]
    keep = np.isfinite(want)
    np.testing.assert_array_equal(got.numpy()[keep], want[keep])


def test_delay_mode_uses_the_injected_clock_as_the_reference():
    slept = {"port": [], "ref": []}
    for key, mod in (("port", faults), ("ref", ref_faults)):
        plan = mod.FaultPlan.single("decode_step", mode="delay", times=2,
                                    arg=0.7)
        plan.sleep = slept[key].append
        assert [plan.fire("decode_step", payload="x") for _ in range(3)] == \
            ["x"] * 3
    assert slept["port"] == slept["ref"] == [0.7, 0.7]


def _activation_trace(mod, monkeypatch):
    out = []
    monkeypatch.setenv(mod.ENV_VAR, "plan_validate:raise:1")
    env_plan = mod.get_active()
    out.append(sorted(env_plan.specs))
    out.append(mod.get_active() is env_plan)          # cached per env string
    override = mod.FaultPlan.single("decode_step")
    with mod.activate(override):
        out.append(mod.get_active() is override)
        with pytest.raises(mod.FaultInjected):
            mod.maybe_fire("decode_step")
        out.append(mod.maybe_fire("page_alloc", payload=3))
    out.append(mod.get_active() is env_plan)
    with mod.activate(None):
        out.append(mod.get_active() is env_plan)      # None falls to the env
    monkeypatch.setenv(mod.ENV_VAR, "page_alloc:raise:2")
    out.append(sorted(mod.get_active().specs))        # re-parsed on change
    monkeypatch.delenv(mod.ENV_VAR)
    out.append(mod.get_active())
    out.append(mod.maybe_fire("decode_step", payload=7))
    return out


def test_activate_overrides_the_env_plan_as_the_reference(monkeypatch):
    assert _activation_trace(faults, monkeypatch) == \
        _activation_trace(ref_faults, monkeypatch)


# -- runtime/guard.py ---------------------------------------------------------------

def _retry_trace(mod, n_failures, retries, base):
    calls, slept, retried = {"n": 0}, [], []

    def flaky():
        calls["n"] += 1
        if calls["n"] <= n_failures:
            raise RuntimeError(f"transient {calls['n']}")
        return "ok"

    try:
        result = mod.retry_with_backoff(
            flaky, retries=retries, base_delay_s=base, sleep=slept.append,
            on_retry=lambda a, e: retried.append((a, str(e))))
    except RuntimeError as exc:
        result = f"raised {exc}"
    return result, calls["n"], slept, retried


@pytest.mark.parametrize("n_failures,retries,base", [
    (0, 2, 0.25), (2, 2, 0.25), (3, 2, 0.25), (1, 0, 0.1), (4, 5, 0.0),
    (5, 3, 1.0)])
def test_retry_with_backoff_as_the_reference(n_failures, retries, base):
    port = _retry_trace(guard, n_failures, retries, base)
    assert port == _retry_trace(ref_guard, n_failures, retries, base)
    if n_failures == 2 and retries == 2:
        assert port == ("ok", 3, [0.25, 0.5],
                        [(0, "transient 1"), (1, "transient 2")])


def test_degradation_log_as_the_reference():
    def trace(mod):
        log, other = mod.DegradationLog(), mod.DegradationLog()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            log.note("calibration_measure", "retry#1", "r1")
            log.note("plan_validate", "schedule->sequential", "r2", warn=True)
        other.note("calib_disk_read", "disk->memory-tier", "r3")
        log.extend(other)
        return (log.as_dicts(), log.count(), log.count("plan_validate"),
                len(log), [(w.category.__name__, str(w.message))
                           for w in caught])
    assert trace(guard) == trace(ref_guard)


# -- core/session.py: the calibration ladder -------------------------------------

def test_calibration_retry_then_success_as_the_reference(tmp_path):
    rg, pg = _pair(1, 2)
    x = _x()
    ref, port = _sessions(tmp_path, fault_plan=FaultPlan.single(
        "calibration_measure", times=1))
    with count_measures() as n:
        assert ref.calibrate(rg, _calib(rg, jnp.asarray(x))) is not None
        assert port.calibrate(pg, _calib(pg, torch.from_numpy(x))) is not None
    assert n == {"ref": 1, "port": 1}
    assert port.cache_stats() == ref.cache_stats()
    assert port.cache_stats()["calib_retries"] == 1
    assert port.guard_log.as_dicts() == ref.guard_log.as_dicts()
    assert [e["action"] for e in port.guard_log.as_dicts()] == ["retry#1"]


def test_calibration_degrades_to_analytic_as_the_reference(tmp_path):
    rg, pg = _pair(2, 3)
    x = _x(1)
    ref, port = _sessions(tmp_path, fault_plan=FaultPlan.single(
        "calibration_measure", times=-1))
    with pytest.warns(ref_guard.DegradationWarning, match="measured->analytic"):
        rm = ref.compile(rg, inputs=_calib(rg, jnp.asarray(x)))
    with pytest.warns(guard.DegradationWarning, match="measured->analytic"):
        pm = port.compile(pg, inputs=_calib(pg, torch.from_numpy(x)))
    assert pm.provenance == rm.provenance
    assert pm.provenance["calibration"] == "analytic (degraded)"
    assert port.cache_stats() == ref.cache_stats()
    assert port.cache_stats()["calib_degraded_analytic"] == 1
    assert port.cache_stats()["calib_retries"] == port.config.calib_retries
    assert pm.explain()["degraded"] == rm.explain()["degraded"]
    assert pm.explain()["cache"] == rm.explain()["cache"]
    got = pm({"x": torch.from_numpy(x)})
    _assert_outputs(got, rm({"x": jnp.asarray(x)}))
    _assert_outputs(got, [np.asarray(o) for o in run_sequential_uncompiled(
        pg, {"x": torch.from_numpy(x)}, pm.executable.output_ids)])


def test_calibration_backoff_uses_the_session_clock_as_the_reference(tmp_path):
    rg, pg = _pair(1, 2)
    x = _x()
    ref, port = _sessions(tmp_path, calib_backoff_s=0.25,
                          fault_plan=FaultPlan.single("calibration_measure",
                                                      times=2))
    delays = {"ref": [], "port": []}
    ref._sleep, port._sleep = delays["ref"].append, delays["port"].append
    ref.calibrate(rg, _calib(rg, jnp.asarray(x)))
    port.calibrate(pg, _calib(pg, torch.from_numpy(x)))
    assert delays["port"] == delays["ref"] == [0.25, 0.5]
    assert port.cache_stats() == ref.cache_stats()


def test_retried_measurement_times_every_payload(tmp_path):
    """On the CPU the profiler times with ``perf_counter``; the retried
    measurement is the same call (CUDA events on the card, see
    ``tests/test_torch_cuda.py``)."""
    _, pg = _pair(1, 2)
    plan = FaultPlan.single("calibration_measure", times=1)
    port = Session(device="cpu", hw=V5E, calib_dir=str(tmp_path),
                   fault_plan=plan)
    table = port.calibrate(pg, _calib(pg, torch.from_numpy(_x())))
    assert plan.fired["calibration_measure"] == 1
    assert table.hw_name == V5E.name
    assert len(table.measured_us) == sum(1 for n in pg if n.fn is not None)
    assert all(us > 0 for _, us in table.measured_us)


# -- core/session.py: the disk tier ----------------------------------------------

def test_disk_write_fault_keeps_the_memory_tier_as_the_reference(tmp_path):
    rg, pg = _pair(1, 2)
    x = _x()
    ref, port = _sessions(tmp_path, fault_plan=FaultPlan.single(
        "calib_disk_write", times=1))
    with count_measures() as n:
        ref.calibrate(rg, _calib(rg, jnp.asarray(x)))
        port.calibrate(pg, _calib(pg, torch.from_numpy(x)))
        ref.calibrate(rg, _calib(rg, jnp.asarray(x)))
        port.calibrate(pg, _calib(pg, torch.from_numpy(x)))
    assert n == {"ref": 1, "port": 1}
    assert port.cache_stats() == ref.cache_stats()
    assert port.cache_stats()["calib_disk_errors"] == 1
    assert port.cache_stats()["calib_hits"] == 1
    assert port.guard_log.as_dicts() == ref.guard_log.as_dicts()
    # nothing published, nothing stranded
    for d in (tmp_path / "ref", tmp_path / "port"):
        assert not d.exists() or not os.listdir(d)


def _corrupt_write_trace(session_cls, g, inputs, tmp, **kw):
    out = []
    s1 = session_cls(calib_dir=tmp, fault_plan=FaultPlan.single(
        "calib_disk_write", mode="corrupt", times=1), **kw)
    s1.calibrate(g, inputs)
    s2 = session_cls(calib_dir=tmp, **kw)
    s2.calibrate(g, inputs)                     # whole but unparseable: miss
    s3 = session_cls(calib_dir=tmp, **kw)
    s3.calibrate(g, inputs)                     # s2 repaired the entry
    for s in (s1, s2, s3):
        out.append(s.cache_stats())
    return out


def test_corrupt_disk_write_is_a_later_miss_as_the_reference(tmp_path):
    rg, pg = _pair(1, 2)
    x = _x()

    def ref_cls(calib_dir, fault_plan=None):
        return RefSession(calib_dir=calib_dir, fault_plan=(
            _ref_plan(fault_plan) if fault_plan else None))

    with count_measures() as n:
        ref = _corrupt_write_trace(ref_cls, rg, _calib(rg, jnp.asarray(x)),
                                   str(tmp_path / "ref"))
        port = _corrupt_write_trace(Session, pg, _calib(pg, torch.from_numpy(x)),
                                    str(tmp_path / "port"), device="cpu",
                                    hw=V5E)
    assert port == ref
    assert n == {"ref": 2, "port": 2}
    assert [s["calib_disk_hits"] for s in port] == [0, 0, 1]


@pytest.mark.parametrize("mode", ["raise", "corrupt"])
def test_disk_read_fault_is_a_miss_as_the_reference(tmp_path, mode):
    """raise: the read error is counted, the graph measured again; corrupt
    (a torn entry): a plain miss, nothing counted as an error."""
    rg, pg = _pair(1, 2)
    x = _x()
    rin, pin = _calib(rg, jnp.asarray(x)), _calib(pg, torch.from_numpy(x))
    ref, port = _sessions(tmp_path)
    ref.calibrate(rg, rin)
    port.calibrate(pg, pin)
    ref, port = _sessions(tmp_path, fault_plan=FaultPlan.single(
        "calib_disk_read", mode=mode, times=1))
    with count_measures() as n:
        ref.calibrate(rg, rin)
        port.calibrate(pg, pin)
    assert n == {"ref": 1, "port": 1}
    assert port.cache_stats() == ref.cache_stats()
    assert port.cache_stats()["calib_disk_hits"] == 0
    assert port.cache_stats()["calib_disk_errors"] == (mode == "raise")
    assert port.guard_log.as_dicts() == ref.guard_log.as_dicts()


def _writers_trace(store, load, evict, table_cls, plan_cls, d):
    tables = {i: table_cls(hw_name="v5e",
                           measured_us=((0, 1.0 + i), (1, 2.0 * i + 1.0)))
              for i in range(8)}
    corrupting = plan_cls.single("calib_disk_write", mode="corrupt", times=1)
    threads = [threading.Thread(target=store, args=(("k", i), tables[i]),
                                kwargs=dict(dirpath=d, faults=corrupting
                                            if i == 3 else None))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stranded = [p for p in os.listdir(d) if p.endswith(".tmp")]
    loaded = [load(("k", i), dirpath=d) == tables[i] for i in range(8)]
    missing = [load(("k", i), dirpath=d) is None for i in range(8)]
    evict(d, max_entries=3)
    return stranded, loaded, missing, len([p for p in os.listdir(d)
                                          if p.endswith(".json")])


def test_disk_tier_survives_concurrent_writers_as_the_reference(tmp_path):
    port = _writers_trace(port_session._calib_disk_store,
                          port_session._calib_disk_load,
                          port_session._calib_disk_evict, ProfileTable,
                          faults.FaultPlan, str(tmp_path / "port"))
    ref = _writers_trace(ref_session._calib_disk_store,
                         ref_session._calib_disk_load,
                         ref_session._calib_disk_evict, RefTable,
                         ref_faults.FaultPlan, str(tmp_path / "ref"))
    assert port == ref
    assert port[0] == [] and port[3] == 3
    assert port[2] == [i == 3 for i in range(8)]


def test_disk_write_abort_leaves_no_partial_entry(tmp_path):
    """An aborted write (raise mode, after the temp file exists) publishes
    nothing and unlinks the temp file; the exception reaches the caller."""
    d = str(tmp_path / "tier")
    table = ProfileTable(hw_name="h100", measured_us=((0, 1.0),))
    with pytest.raises(FaultInjected):
        port_session._calib_disk_store(
            ("k",), table, dirpath=d,
            faults=FaultPlan.single("calib_disk_write", times=1))
    assert os.listdir(d) == []
    port_session._calib_disk_store(("k",), table, dirpath=d)
    assert port_session._calib_disk_load(("k",), dirpath=d) == table
    assert [p.endswith(".json") for p in os.listdir(d)] == [True]


# -- core/session.py: plan_validate ------------------------------------------------

def test_plan_validate_degrades_to_sequential_as_the_reference(tmp_path):
    rg, pg = _pair(2, 3)
    x = _x(2)
    ref, port = _sessions(tmp_path, fault_plan=FaultPlan.single(
        "plan_validate", times=1))
    with pytest.warns(ref_guard.DegradationWarning,
                      match="schedule->sequential"):
        rm = ref.compile(rg)
    with pytest.warns(guard.DegradationWarning, match="schedule->sequential"):
        pm = port.compile(pg)
    assert pm.provenance == rm.provenance
    assert pm.provenance["executable"] == "degraded"
    assert port.cache_stats() == ref.cache_stats()
    assert port.cache_stats()["exec_entries"] == 0
    strip = [{k: e[k] for k in ("site", "action")}
             for e in pm.explain()["degraded"]]
    assert strip == [{k: e[k] for k in ("site", "action")}
                     for e in rm.explain()["degraded"]]
    assert "injected fault at site 'plan_validate'" in \
        pm.explain()["degraded"][0]["reason"]
    got = pm({"x": torch.from_numpy(x)})
    _assert_outputs(got, rm({"x": jnp.asarray(x)}))
    # disarmed: the real schedule compiles and is cached, in both
    assert port.compile(pg).provenance["executable"] == \
        ref.compile(rg).provenance["executable"] == "miss"
    assert port.compile(pg).provenance["executable"] == \
        ref.compile(rg).provenance["executable"] == "hit"
    assert port.cache_stats() == ref.cache_stats()


_DEGRADING_SITES = ("calibration_measure", "calib_disk_read",
                    "calib_disk_write", "plan_validate")


@pytest.mark.parametrize("site", _DEGRADING_SITES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_single_site_fault_matches_the_fault_free_run(tmp_path, seed, site):
    """Any single Session site with a rung below it: the same outputs as
    the fault-free run and as the JAX package's faulted build, and the same
    counters."""
    rg, pg = _pair(1 + seed % 3, 2 + seed % 2, seed=seed)
    x = _x(seed)
    rin, pin = _calib(rg, jnp.asarray(x)), _calib(pg, torch.from_numpy(x))
    if site == "calib_disk_read":       # the read site needs a populated tier
        for s in _sessions(tmp_path):
            s.calibrate(*((rg, rin) if isinstance(s, RefSession)
                          else (pg, pin)))
    ref, port = _sessions(tmp_path, fault_plan=FaultPlan.single(site,
                                                                times=-1),
                          load_calibration=(site == "calib_disk_read"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", guard.DegradationWarning)
        warnings.simplefilter("ignore", ref_guard.DegradationWarning)
        rm = ref.compile(rg, inputs=rin)
        pm = port.compile(pg, inputs=pin)
    got = pm({"x": torch.from_numpy(x)})
    _assert_outputs(got, rm({"x": jnp.asarray(x)}))
    _assert_outputs(got, [np.asarray(o) for o in ref_sequential(
        rg, {"x": jnp.asarray(x)})])
    assert port.cache_stats() == ref.cache_stats()
    stats = port.cache_stats()
    assert stats["degraded_routes"] + stats["calib_degraded_analytic"] \
        + stats["calib_disk_errors"] >= 1


def test_env_plan_arms_a_session_as_the_reference(tmp_path, monkeypatch):
    rg, pg = _pair(1, 2)
    monkeypatch.setenv(faults.ENV_VAR, "plan_validate:raise:-1")
    monkeypatch.setenv(ref_faults.ENV_VAR, "plan_validate:raise:-1")
    ref, port = _sessions(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert port.compile(pg).provenance == ref.compile(rg).provenance
        assert port.compile(pg).provenance["executable"] == "degraded"


# -- core/capture.py: the fused-route sites and the call-time rule (C28) ---------

@contextlib.contextmanager
def _no_cuda_graph_opened():
    """Fail if anything opens ``torch.cuda.graph`` inside the block."""
    real = torch.cuda.graph

    class refusing(real):
        def __init__(self, *a, **k):
            raise AssertionError("a CUDA graph was opened")

    torch.cuda.graph = refusing
    try:
        yield
    finally:
        torch.cuda.graph = real


@pytest.mark.parametrize("site,graph", [("kernel_compile", "inception"),
                                        ("grouped_gemm_route", "ragged")])
def test_fused_route_site_raises_where_the_reference_degrades(
        tmp_path, site, graph):
    """C28: the JAX package degrades (branch_gemm->vmap,
    grouped_gemm->sequential); the port raises ``FaultInjected`` out of
    lowering, before a CUDA graph could open, caches nothing, and once
    disarmed compiles the kernel route, caches it and computes what the
    reference's degraded build computes."""
    rg, pg = _pair(2, 3) if graph == "inception" else _ragged_pair()
    kernel = "n_branch_gemm" if graph == "inception" else "n_grouped_gemm"
    inputs = _inputs_np(pg)
    ref = RefSession(calib_dir=str(tmp_path / "ref"), gemm_kernel="pallas",
                     fault_plan=ref_faults.FaultPlan.single(site, times=-1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ref_guard.DegradationWarning)
        rm = ref.compile(rg)
    assert rm.provenance["executable"] == "degraded"
    assert rm.executable.program_stats()[kernel] == 0
    assert [e["action"] for e in rm.explain()["degraded"]][:1] == [
        "branch_gemm->vmap" if graph == "inception"
        else "grouped_gemm->sequential"]

    port = Session(device="cpu", hw=V5E, calib_dir=str(tmp_path / "port"),
                   gemm_kernel="kernel")
    plan = FaultPlan.single(site, times=-1)
    with faults.activate(plan), _no_cuda_graph_opened(), \
            pytest.raises(FaultInjected) as exc:
        port.compile(pg)
    assert exc.value.site == site and plan.fired[site] == 1
    stats = port.cache_stats()
    assert stats["exec_entries"] == 0 and stats["degraded_routes"] == 0
    assert len(port.guard_log) == 0
    model = port.compile(pg)                      # disarmed
    assert model.provenance["executable"] == "miss"
    assert model.executable.program_stats()[kernel] >= 1
    assert port.compile(pg).provenance["executable"] == "hit"
    got = model({k: torch.from_numpy(v) for k, v in inputs.items()})
    _assert_outputs(got, rm({k: jnp.asarray(v) for k, v in inputs.items()}))


def test_call_time_failure_propagates_where_the_reference_rescues(tmp_path):
    """C28: the JAX package rescues a compiled program that fails when
    called (``jitted->sequential``); the port's executable raises and
    records nothing."""
    def ref_payload(x):
        if isinstance(x, jax.core.Tracer):
            raise RuntimeError("fails when traced")
        return x * 2.0

    armed = {"fail": False}

    def port_payload(x):
        if armed["fail"]:
            raise RuntimeError("fails at call time")
        return x * 2.0

    def build(graph_mod, fn):
        g = graph_mod.OpGraph("call-time")
        a = g.add("x", graph_mod.OpKind.INPUT, out_shape=(4, 8))
        g.add("double", graph_mod.OpKind.ELEMENTWISE, [a], fn=fn)
        g.validate()
        return g

    x = _x(0, (4, 8))
    ref = RefSession(calib_dir=str(tmp_path / "ref"))
    rm = ref.compile(build(ref_graph, ref_payload))
    with pytest.warns(ref_guard.DegradationWarning, match="jitted->sequential"):
        want = rm({"x": jnp.asarray(x)})
    assert [e["action"] for e in rm.explain()["degraded"]] == [
        "jitted->sequential"]

    port = Session(device="cpu", hw=V5E, calib_dir=str(tmp_path / "port"))
    pm = port.compile(build(port_graph, port_payload))
    _assert_outputs(pm({"x": torch.from_numpy(x)}), want)
    armed["fail"] = True
    with pytest.raises(RuntimeError, match="fails at call time"):
        pm({"x": torch.from_numpy(x)})
    assert pm.explain()["degraded"] == []
    assert len(pm.executable.degradations) == 0
    assert port.cache_stats()["degraded_routes"] == 0


def test_plan_validate_fires_before_the_fused_route_sites(tmp_path):
    """``plan_validate`` fires before lowering and ``kernel_compile`` /
    ``grouped_gemm_route`` while lowering: a plan that arms all three
    stops at the first, which the session rescues; the fused-route sites
    then fire in the rescue-free rebuild once ``plan_validate`` is spent."""
    _, pg = _pair(2, 3)
    port = Session(device="cpu", hw=V5E, calib_dir=str(tmp_path),
                   gemm_kernel="kernel")
    plan = FaultPlan([FaultSpec("plan_validate", times=1),
                      FaultSpec("kernel_compile", times=1)])
    with faults.activate(plan), warnings.catch_warnings():
        warnings.simplefilter("ignore", guard.DegradationWarning)
        model = port.compile(pg)
        assert model.provenance["executable"] == "degraded"
        assert plan.fired == {"plan_validate": 1, "kernel_compile": 0}
        with pytest.raises(FaultInjected, match="kernel_compile"):
            port.compile(pg)
        assert plan.fired == {"plan_validate": 1, "kernel_compile": 1}
    assert port.compile(pg).executable.program_stats()["n_branch_gemm"] >= 1
