"""The port's Session caches against the JAX package's.

The cases of ``tests/test_session.py`` and ``tests/test_cache_properties.py``
that apply to the port, each run on the port's Session and on the JAX
package's Session over the same graph (built in both packages from one
numpy seed, ``test_torch_faults._pair``): the config's validation, kwarg
overrides, cold / warm / disk provenance in ``explain()["cache"]``, the
counters of ``cache_stats()``, per-session isolation, ``clear_caches``, the
LRU bounds of each tier (a model check of ``_lru_get`` / ``_lru_put``
against a reference LRU), signature invalidation, the calibration key's
input geometry and the default session behind the legacy shims.  The port's
default session runs on the card, so the shim cases install a CPU default
session first.  Outputs: fp32 1e-5.
"""
import dataclasses
import warnings
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import Session as RefSession  # noqa: E402
from repro.core import SessionConfig as RefConfig  # noqa: E402
from repro.core import SimConfig as RefSimConfig  # noqa: E402
from repro.core import api as ref_api  # noqa: E402
from repro.core import calibration_key as ref_calibration_key  # noqa: E402
from repro.core import graph_signature as ref_graph_signature  # noqa: E402
from repro.core import session as ref_session  # noqa: E402
from repro.core.graph import OpGraph as RefGraph  # noqa: E402
from repro.core.graph import OpKind as RefKind  # noqa: E402
from repro.core.profiler import apply_profile as ref_apply  # noqa: E402
from repro.core.profiler import detach_profile as ref_detach  # noqa: E402
from repro_torch.core import (V5E, CompiledModel, HardwareSpec,  # noqa: E402
                              Session, SessionConfig, SimConfig,
                              apply_profile, calibration_key, default_session,
                              detach_profile, graph_signature,
                              reset_default_session)
from repro_torch.core import api as port_api  # noqa: E402
from repro_torch.core import session as port_session  # noqa: E402
from repro_torch.core.capture import run_sequential_uncompiled  # noqa: E402
from repro_torch.core.graph import OpGraph, OpKind  # noqa: E402
from repro_torch.core.profiler import ProfileTable  # noqa: E402

from test_torch_faults import (_assert_outputs, _calib, _pair,  # noqa: E402
                               _port_inception, _sessions, _x,
                               count_measures)
from conftest import build_inception_like  # noqa: E402


def _both_compile(ref, port, rg, pg, x=None):
    rin = None if x is None else _calib(rg, jnp.asarray(x))
    pin = None if x is None else _calib(pg, torch.from_numpy(x))
    return ref.compile(rg, inputs=rin), port.compile(pg, inputs=pin)


@pytest.fixture
def cpu_default_session(tmp_path):
    """The port's default session on the CPU (its default runs on the
    card), restored to a fresh default after the test."""
    sess = reset_default_session(SessionConfig(device="cpu", hw=V5E,
                                               calib_dir=str(tmp_path / "p")))
    yield sess
    port_session._default_session = None


# -- SessionConfig ----------------------------------------------------------------

@pytest.mark.parametrize("bad", [dict(alloc_policy="bogus"),
                                 dict(order_policy="bogus"),
                                 dict(gemm_kernel="bogus"),
                                 dict(cache_size=0),
                                 dict(calib_retries=-1)],
                         ids=lambda d: next(iter(d)))
def test_config_validates_as_the_reference(bad):
    with pytest.raises(ValueError):
        RefConfig(**bad)
    with pytest.raises(ValueError):
        SessionConfig(device="cpu", **bad)


def test_config_is_frozen_and_hashable_and_routes_name_the_port():
    cfg = SessionConfig(device="cpu", autotune=True,
                        sim_cfg=SimConfig(resource_cap=1e6))
    assert hash(cfg) == hash(dataclasses.replace(cfg))
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.autotune = False
    # the reference's "pallas" route is the port's "kernel"
    with pytest.raises(ValueError):
        SessionConfig(gemm_kernel="pallas")
    RefConfig(gemm_kernel="pallas")
    with pytest.raises(ValueError):
        SessionConfig(device="tpu")


def test_kwarg_overrides_build_the_config_as_the_reference():
    base, ref_base = (SessionConfig(device="cpu", hw=V5E, autotune=True),
                      RefConfig(autotune=True))
    port, ref = Session(base, order_policy="topo"), RefSession(
        ref_base, order_policy="topo")
    for s, b in ((port, base), (ref, ref_base)):
        assert s.config.autotune and s.config.order_policy == "topo"
        assert b.order_policy == "opara"
    assert Session(device="cpu", hw=HardwareSpec(name="x")).config.hw.name \
        == "x"
    with pytest.raises(ValueError, match="explicit hw"):
        Session(device="cpu")


# -- compile() / CompiledModel ------------------------------------------------------

def test_cold_then_warm_provenance_as_the_reference(tmp_path):
    rg, pg = _pair(3, 4)
    ref, port = _sessions(tmp_path)
    rc, pc = _both_compile(ref, port, rg, pg)
    assert isinstance(pc, CompiledModel)
    assert pc.provenance == rc.provenance == {
        "calibration": "off", "plan": "miss", "executable": "miss"}
    x = _x(3)
    got = pc({"x": torch.from_numpy(x)})
    _assert_outputs(got, rc({"x": jnp.asarray(x)}))
    _assert_outputs(got, [o.numpy() for o in run_sequential_uncompiled(
        pg, {"x": torch.from_numpy(x)}, pc.executable.output_ids)])
    rw, pw = _both_compile(ref, port, rg, pg)
    assert pw.provenance == rw.provenance == {
        "calibration": "off", "plan": "hit", "executable": "hit"}
    assert pw.executable is pc.executable and pw.plan is pc.plan
    assert port.cache_stats() == ref.cache_stats()


def test_explain_reports_stages_and_provenance_as_the_reference(tmp_path):
    rg, pg = _pair(2, 3)
    x = _x(4)
    ref, port = _sessions(tmp_path)
    rc, pc = _both_compile(ref, port, rg, pg, x)
    rep, ref_rep = pc.explain(), rc.explain()
    assert rep["cache"] == ref_rep["cache"] == {
        "calibration": "measured", "plan": "miss", "executable": "miss"}
    assert rep["graph"] == ref_rep["graph"]
    assert rep["config"]["hw"] == port.config.hw.name
    assert set(rep["stages_ms"]) == set(ref_rep["stages_ms"])
    assert rep["stages_ms"]["total"] >= rep["stages_ms"]["plan"]
    assert rep["schedule"]["n_streams"] >= 1
    assert set(rep) == set(ref_rep)
    rw, pw = _both_compile(ref, port, rg, pg, x)
    assert pw.explain()["cache"] == rw.explain()["cache"] == {
        "calibration": "memory", "plan": "hit", "executable": "hit"}
    # fresh sessions sharing only the disk tier
    ref2, port2 = _sessions(tmp_path)
    rd, pd = _both_compile(ref2, port2, rg, pg, x)
    assert pd.explain()["cache"] == rd.explain()["cache"]
    assert pd.explain()["cache"]["calibration"] == "disk"
    assert pd.explain()["cache"]["plan"] == "miss"
    assert port2.cache_stats() == ref2.cache_stats()
    assert pc.stats == pc.plan.stats()


def test_autotuned_compile_and_explain_as_the_reference(tmp_path):
    rg, pg = _pair(3, 4)
    sim = SimConfig(resource_cap=24e6, head_of_line=True)
    ref = RefSession(calib_dir=str(tmp_path / "r"), autotune=True,
                     sim_cfg=RefSimConfig(
                         resource_cap=24e6, head_of_line=True))
    port = Session(device="cpu", hw=V5E, calib_dir=str(tmp_path / "p"),
                   autotune=True, sim_cfg=sim)
    rc, pc = _both_compile(ref, port, rg, pg)
    assert pc.plan.n_candidates == rc.plan.n_candidates >= 2
    assert pc.explain()["config"]["autotune"] is True
    assert pc.explain()["config"]["alloc_policy"] == \
        rc.explain()["config"]["alloc_policy"]
    x = _x(5)
    _assert_outputs(pc({"x": torch.from_numpy(x)}), rc({"x": jnp.asarray(x)}))
    assert port.compile(pg).provenance["plan"] == \
        ref.compile(rg).provenance["plan"] == "hit"


# -- isolation ---------------------------------------------------------------------

def test_sessions_with_different_configs_share_nothing_as_the_reference(
        tmp_path):
    rg, pg = _pair(2, 3)
    x = _x(6)
    out = []
    for (s1, s2), g, x_ in (
            ((RefSession(calib_dir=str(tmp_path / "r")),
              RefSession(calib_dir=str(tmp_path / "r"), order_policy="topo")),
             rg, jnp.asarray(x)),
            ((Session(device="cpu", hw=V5E, calib_dir=str(tmp_path / "p")),
              Session(device="cpu", hw=V5E, calib_dir=str(tmp_path / "p"),
                      order_policy="topo")), pg, torch.from_numpy(x))):
        s1.compile(g, inputs=_calib(g, x_))
        untouched = s2.cache_stats()
        m2 = s2.compile(g)
        out.append((untouched, m2.provenance, s1.cache_stats(),
                    s2.cache_stats()))
    assert out[1] == out[0]
    assert all(v == 0 for v in out[1][0].values())
    assert out[1][1]["plan"] == "miss"


def test_sessions_with_equal_configs_are_isolated_as_the_reference(tmp_path):
    rg, pg = _pair(2, 3)
    out = []
    for make, g in ((lambda: RefSession(calib_dir=str(tmp_path / "r")), rg),
                    (lambda: Session(device="cpu", hw=V5E,
                                     calib_dir=str(tmp_path / "p")), pg)):
        s1, s2 = make(), make()
        e1 = s1.optimize(g)
        e2 = s2.optimize(g)
        out.append((s2.cache_stats(), e2 is e1))
    assert out[1] == out[0]
    assert out[1][0]["exec_misses"] == 1 and out[1][1] is False


def test_clear_caches_leaves_the_other_session_warm_as_the_reference(
        tmp_path):
    rg, pg = _pair(2, 3)
    x = _x(7)
    out = []
    for make, g, x_ in (
            (lambda: RefSession(calib_dir=str(tmp_path / "r")), rg,
             jnp.asarray(x)),
            (lambda: Session(device="cpu", hw=V5E,
                             calib_dir=str(tmp_path / "p")), pg,
             torch.from_numpy(x))):
        s1, s2 = make(), make()
        s1.compile(g, inputs=_calib(g, x_))
        s2.compile(g, inputs=_calib(g, x_))
        s1.clear_caches()
        cleared = s1.cache_stats()
        warm = s2.compile(g, inputs=_calib(g, x_)).provenance
        cold = s1.compile(g, inputs=_calib(g, x_)).provenance
        out.append((cleared, warm, cold))
    assert out[1] == out[0]
    assert all(v == 0 for v in out[1][0].values())
    assert out[1][1] == {"calibration": "memory", "plan": "hit",
                         "executable": "hit"}
    assert out[1][2]["plan"] == "miss" and out[1][2]["calibration"] == "disk"


def test_memory_tiers_are_isolated_across_sessions_as_the_reference(tmp_path):
    rg, pg = _pair(1, 2)
    x = _x(8)
    with count_measures() as n:
        for s in (RefSession(calib_dir=str(tmp_path / "r"),
                             load_calibration=False),
                  RefSession(calib_dir=str(tmp_path / "r"),
                             load_calibration=False)):
            s.calibrate(rg, _calib(rg, jnp.asarray(x)), repeats=1)
        for s in (Session(device="cpu", hw=V5E, calib_dir=str(tmp_path / "p"),
                          load_calibration=False),
                  Session(device="cpu", hw=V5E, calib_dir=str(tmp_path / "p"),
                          load_calibration=False)):
            s.calibrate(pg, _calib(pg, torch.from_numpy(x)), repeats=1)
    assert n == {"ref": 2, "port": 2}


# -- default session + legacy shims ------------------------------------------------

def test_default_session_backs_the_shims_as_the_reference(
        cpu_default_session):
    rg, pg = _pair(2, 3)
    out = []
    for api, default, g in ((ref_api, ref_session.default_session, rg),
                            (port_api, default_session, pg)):
        p = api.plan(g)
        out.append(default().cache_stats()["plan_misses"])
        out.append(default().plan(g) is p)
        api.clear_caches()
        out.append(api.cache_stats()["plan_entries"])
    assert out[3:] == out[:3] == [1, True, 0]
    assert default_session() is cpu_default_session


def test_reset_default_session_swaps_state(cpu_default_session):
    _, pg = _pair(2, 3)
    port_api.plan(pg)
    new = reset_default_session(cpu_default_session.config)
    assert new is default_session() and new is not cpu_default_session
    assert new.cache_stats()["plan_entries"] == 0


def test_shims_warn_on_superseded_kwargs_only(cpu_default_session):
    _, pg = _pair(2, 3)
    inputs = _calib(pg, torch.from_numpy(_x()))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_api.plan(pg)
        port_api.optimize(pg)
        port_api.plan(pg, measured_inputs=inputs)
        port_api.calibrate(pg, inputs, repeats=1)
    with pytest.warns(DeprecationWarning, match="alloc_policy"):
        port_api.plan(pg, alloc_policy="nimble")
    with pytest.warns(DeprecationWarning, match="weights_key"):
        port_api.optimize(pg, weights_key="content")
    with pytest.warns(DeprecationWarning, match="hw"):
        port_api.calibrate(pg, inputs, hw=V5E, repeats=1)


def test_shim_kwargs_delegate_as_the_reference(cpu_default_session):
    rg, pg = _pair(2, 3)
    out = []
    for api, default, g in ((ref_api, ref_session.default_session, rg),
                            (port_api, default_session, pg)):
        with pytest.warns(DeprecationWarning):
            p_topo = api.plan(g, order_policy="topo")
        p_def = api.plan(g)
        with pytest.warns(DeprecationWarning):
            again = api.plan(g, order_policy="topo")
        out.append((p_topo.order_policy, p_def.order_policy,
                    default().cache_stats()["plan_misses"], again is p_topo))
    assert out[1] == out[0] == ("topo", "opara", 2, True)


# -- the LRU bounds ------------------------------------------------------------------

def test_plan_cache_size_bounds_entries_as_the_reference():
    out = []
    for sess, build in (
            (RefSession(cache_size=2), lambda b: build_inception_like(
                n_blocks=b, width=2, with_payloads=False)),
            (Session(device="cpu", hw=V5E, cache_size=2),
             lambda b: _port_inception(n_blocks=b, width=2))):
        for blocks in (1, 2, 3, 4):
            sess.plan(build(blocks))
        out.append(sess.cache_stats())
    assert out[1] == out[0]
    assert out[1]["plan_entries"] == 2


def _lru_trace(get, put, ops, capacity):
    cache, got = OrderedDict(), []
    for op, key, val in ops:
        if op == "put":
            put(cache, key, val, max_entries=capacity)
        else:
            got.append(get(cache, key))
    return list(cache.items()), got


def _model_lru(ops, capacity):
    """A plain LRU: dict + recency list, evict the least recent on put."""
    store, recency, out = {}, [], []
    for op, key, val in ops:
        if key in recency and (op == "put" or key in store):
            recency.remove(key)
        if op == "put":
            store[key] = val
            recency.append(key)
            while len(store) > capacity:
                del store[recency.pop(0)]
        else:
            out.append(store.get(key))
            if key in store:
                recency.append(key)
    return store, out


@pytest.mark.parametrize("seed", range(12))
def test_lru_matches_the_model_and_the_reference(seed):
    rng = np.random.default_rng(seed)
    ops = [("put" if rng.random() < 0.5 else "get",
            (int(rng.integers(8)),), int(rng.integers(1000)))
           for _ in range(60)]
    capacity = 1 + seed % 6
    port = _lru_trace(port_session._lru_get, port_session._lru_put, ops,
                      capacity)
    assert port == _lru_trace(ref_session._lru_get, ref_session._lru_put,
                              ops, capacity)
    store, gets = _model_lru(ops, capacity)
    assert dict(port[0]) == store and port[1] == gets
    assert len(port[0]) <= capacity


def test_lru_hit_refresh_and_eviction_order():
    c = OrderedDict()
    port_session._lru_put(c, ("a",), 1, max_entries=2)
    assert port_session._lru_get(c, ("a",)) == 1
    port_session._lru_put(c, ("b",), 2, max_entries=2)
    assert port_session._lru_get(c, ("a",)) == 1          # refresh "a"
    port_session._lru_put(c, ("c",), 3, max_entries=2)    # evicts "b"
    assert port_session._lru_get(c, ("b",)) is None
    assert port_session._lru_get(c, ("a",)) == 1
    assert port_session._lru_get(c, ("c",)) == 3


def test_calibration_cache_evicts_lru_as_the_reference(tmp_path):
    rg, pg = _pair(1, 2)
    shapes = [(4, 64), (8, 64), (16, 64)]
    out = []
    for sess, g, tensor in (
            (RefSession(calib_dir=str(tmp_path / "r"), cache_size=2), rg,
             lambda s: jnp.ones(s, jnp.float32)),
            (Session(device="cpu", hw=V5E, calib_dir=str(tmp_path / "p"),
                     cache_size=2), pg, lambda s: torch.ones(s))):
        for s in shapes:
            sess.calibrate(g, {0: tensor(s)}, repeats=1)
        entries = sess.cache_stats()["calib_entries"]
        sess.calibrate(g, {0: tensor(shapes[0])}, repeats=1, load=False)
        sess.calibrate(g, {0: tensor(shapes[2])}, repeats=1)
        out.append((entries, sess.cache_stats()))
    assert out[1] == out[0]
    assert out[1][0] == 2
    assert out[1][1]["calib_misses"] == 4 and out[1][1]["calib_hits"] == 1


# -- signatures, keys and clearing ------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_add_invalidates_the_signature_and_plan_cache_as_the_reference(seed):
    out = []
    for sess, g, kind, sig in (
            (RefSession(), build_inception_like(
                n_blocks=1 + seed % 3, width=2 + seed % 3,
                with_payloads=False, seed=seed), RefKind.ELEMENTWISE,
             ref_graph_signature),
            (Session(device="cpu", hw=V5E), _port_inception(
                n_blocks=1 + seed % 3, width=2 + seed % 3, seed=seed),
             OpKind.ELEMENTWISE, graph_signature)):
        sig1 = sig(g)
        sess.plan(g)
        g.add(f"extra{seed}", kind, [0])
        changed = sig(g) != sig1
        sess.plan(g)
        out.append((changed, sess.cache_stats()))
    assert out[1] == out[0]
    assert out[1][0] and out[1][1]["plan_hits"] == 0


def test_add_drops_the_hydrated_calibration(tmp_path):
    _, pg = _pair(2, 2)
    Session(device="cpu", hw=V5E, calib_dir=str(tmp_path)).calibrate(
        pg, {0: torch.ones(8, 64)}, repeats=1)
    assert pg.calibration_fp is not None
    pg.add("extra", OpKind.ELEMENTWISE, [0])
    assert pg.calibration_fp is None
    assert all(n.cost.measured_us is None for n in pg)


def test_clear_caches_zeroes_stats_and_entries_as_the_reference(tmp_path):
    rg, pg = _pair(2, 2)
    out = []
    for sess, g, x in ((RefSession(calib_dir=str(tmp_path / "r")), rg,
                        jnp.ones((8, 64), jnp.float32)),
                       (Session(device="cpu", hw=V5E,
                                calib_dir=str(tmp_path / "p")), pg,
                        torch.ones(8, 64))):
        sess.plan(g)
        sess.optimize(g)
        sess.calibrate(g, {0: x}, repeats=1)
        before = sess.cache_stats()
        sess.clear_caches()
        out.append((before, sess.cache_stats()))
    assert out[1] == out[0]
    assert out[1][0]["plan_misses"] and out[1][0]["exec_misses"] \
        and out[1][0]["calib_misses"]
    assert all(v == 0 for v in out[1][1].values())


def test_calibration_key_distinguishes_input_geometry_as_the_reference():
    out = []
    for graph_cls, kind, key, ones, zeros, f32, bf16 in (
            (RefGraph, RefKind, ref_calibration_key, jnp.ones, jnp.zeros,
             jnp.float32, jnp.bfloat16),
            (OpGraph, OpKind, calibration_key,
             lambda s, d: torch.ones(s, dtype=d),
             lambda s, d: torch.zeros(s, dtype=d), torch.float32,
             torch.bfloat16)):
        g = graph_cls("g")
        a = g.add("x", kind.INPUT)
        g.add("y", kind.ELEMENTWISE, [a], fn=lambda v: v * 2)
        k1 = key(g, {a: ones((4, 8), f32)})
        k2 = key(g, {a: ones((8, 8), f32)})
        k3 = key(g, {a: ones((4, 8), bf16)})
        k4 = key(g, {a: zeros((4, 8), f32)})      # values do not enter
        out.append((len({k1, k2, k3}), k4 == k1))
    assert out[1] == out[0] == (3, True)


def test_profile_table_detaches_and_reapplies_as_the_reference(tmp_path):
    rg, pg = _pair(1, 2)
    out = []
    for sess, g, x, detach, apply in (
            (RefSession(calib_dir=str(tmp_path / "r")), rg,
             jnp.ones((8, 64), jnp.float32), ref_detach, ref_apply),
            (Session(device="cpu", hw=V5E, calib_dir=str(tmp_path / "p")), pg,
             torch.ones(8, 64), detach_profile, apply_profile)):
        sess.calibrate(g, {0: x}, repeats=1)
        table = detach(g)
        cleared = (g.calibration_fp is None
                   and all(n.cost.measured_us is None for n in g))
        apply(g, table)
        out.append((cleared, g.calibration_fp == table.fingerprint,
                    sorted(dict(table.measured_us)) == sorted(
                        n.op_id for n in g if n.cost.measured_us is not None)))
    assert out[1] == out[0] == (True, True, True)
    assert isinstance(table, ProfileTable)


@pytest.mark.parametrize("site", ["calibration_measure", "calib_disk_read",
                                  "calib_disk_write", "page_release",
                                  "decode_step", "paged_kv"])
def test_noted_degradations_count_as_the_reference(tmp_path, site):
    """``note_degradation`` (the engine's calibration, paged-KV and
    watchdog events) increments the counter of its site's tier, as the JAX
    package's does."""
    ref, port = _sessions(tmp_path)
    for s in (ref, port):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s.note_degradation(site, "a->b", "why")
            s.note_degradation(site, "a->b", "why", warn=False)
    assert port.cache_stats() == ref.cache_stats()
    assert port.guard_log.as_dicts() == ref.guard_log.as_dicts()
