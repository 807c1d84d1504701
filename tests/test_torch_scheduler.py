"""Plan parity: the same graph schedules identically in both packages.

The scheduling core is pure Python copied from the JAX package, so every
artifact must be EQUAL, not close: stream plans, launch orders, wave
schedules with their fusion groups, cost-model makespans (bit-equal float
arithmetic) and the autotune choice.  Graphs: seeded random DAGs, the
qwen2 smoke payload export, and the full-width qwen2-0.5b cost-only export
at batch 1, seq 512.
"""
import dataclasses
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.core import profiler as ref_profiler  # noqa: E402
from repro.core import scheduler as ref_scheduler  # noqa: E402
from repro.core import simulator as ref_simulator  # noqa: E402
from repro.models.model import make_model  # noqa: E402
from repro.models.opgraph_export import build_lm_opgraph as ref_export  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import graph as port_graph  # noqa: E402
from repro_torch.core import profiler as port_profiler  # noqa: E402
from repro_torch.core import scheduler as port_scheduler  # noqa: E402
from repro_torch.core import simulator as port_simulator  # noqa: E402
from repro_torch.core.launch_order import ORDER_POLICIES  # noqa: E402
from repro_torch.models.opgraph_export import build_lm_opgraph  # noqa: E402

HOL = dict(head_of_line=True)


def _random_spec(seed, n=40, p_edge=0.3, p_heavy=0.3):
    rng = np.random.default_rng(seed)
    spec = []
    for i in range(n):
        preds = [j for j in range(i) if rng.random() < p_edge][-4:]
        if i == 0:
            preds = []
        if rng.random() < p_heavy:
            spec.append(("gemm", preds, int(rng.integers(8, 128))))
        else:
            spec.append(("ew", preds, int(rng.integers(1, 64)) * 1024))
    return spec


def _build(spec, graph_mod, profiler_mod):
    g = graph_mod.OpGraph("rand")
    for i, (kind, preds, size) in enumerate(spec):
        if kind == "gemm":
            g.add(f"op{i}", graph_mod.OpKind.GEMM, preds,
                  cost=profiler_mod.gemm_cost(size, 256, 256, 4),
                  fuse_sig=("gemm", 256))
        else:
            g.add(f"op{i}", graph_mod.OpKind.ELEMENTWISE, preds,
                  cost=profiler_mod.elementwise_cost(size, 4))
    g.validate()
    return g


def _random_pair(seed):
    spec = _random_spec(seed)
    return (_build(spec, ref_graph, ref_profiler),
            _build(spec, port_graph, port_profiler))


def _qwen_smoke_pair():
    rc = ref_config("qwen2-0.5b", smoke=True)
    params = make_model(rc).init(jax.random.key(0))
    tparams = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                "cpu")
    return (ref_export(rc, batch=2, seq=8, params=params),
            build_lm_opgraph(get_config("qwen2-0.5b", smoke=True), batch=2,
                             seq=8, params=tparams))


def _qwen_full_cost_pair():
    return (ref_export(ref_config("qwen2-0.5b"), batch=1, seq=512),
            build_lm_opgraph(get_config("qwen2-0.5b"), batch=1, seq=512))


GRAPHS = {
    "random0": lambda: _random_pair(0),
    "random1": lambda: _random_pair(1),
    "random2": lambda: _random_pair(7),
    "qwen2_smoke_payload": _qwen_smoke_pair,
    "qwen2_0_5b_full_cost_only": _qwen_full_cost_pair,
}


def _waves(ws):
    return [(w.index, tuple(w.op_ids), tuple(map(tuple, w.fusion_groups)))
            for w in ws.waves]


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def pair(request):
    return request.param, GRAPHS[request.param]()


def test_graph_signatures_are_equal(pair):
    _, (rg, pg) = pair
    assert len(rg) == len(pg)
    assert [n.name for n in rg] == [n.name for n in pg]
    # no exported or random node declares a dtype, so even the digests of
    # the raw signatures agree
    assert rg.node_signature() == pg.node_signature()
    assert rg.signature_digest() == pg.signature_digest()


def test_profiles_and_intensity_classes_are_equal(pair):
    _, (rg, pg) = pair
    rp = ref_profiler.ModelProfiler(ref_profiler.V5E).profile(rg)
    pp = port_profiler.ModelProfiler(port_profiler.V5E).profile(pg)
    assert [(p.intensity.value, p.est_us) for p in rp.values()] == \
        [(p.intensity.value, p.est_us) for p in pp.values()]


@pytest.mark.parametrize("alloc", ["opara", "nimble", "sequential"])
def test_schedule_artifacts_are_equal(pair, alloc):
    name, (rg, pg) = pair
    for order in sorted(ORDER_POLICIES):
        for repack in (False, True):
            cfg_r = ref_simulator.SimConfig(**HOL)
            cfg_p = port_simulator.SimConfig(**HOL)
            rp = ref_scheduler.schedule(rg, alloc, order, repack=repack,
                                        sim_cfg=cfg_r)
            pp = port_scheduler.schedule(pg, alloc, order, repack=repack,
                                         sim_cfg=cfg_p)
            assert rp.stream_plan.stream_of == pp.stream_plan.stream_of
            assert rp.stream_plan.n_streams == pp.stream_plan.n_streams
            assert rp.order == pp.order, (alloc, order, repack)
            assert _waves(rp.waves) == _waves(pp.waves)
            assert (ref_scheduler.estimate_plan(rp, cfg_r)
                    == port_scheduler.estimate_plan(pp, cfg_p))


def test_autotune_choice_is_equal(pair):
    name, (rg, pg) = pair
    refine = name.startswith("random")
    rp = ref_scheduler.autotune(rg, cfg=ref_simulator.SimConfig(**HOL),
                                refine=refine)
    pp = port_scheduler.autotune(pg, cfg=port_simulator.SimConfig(**HOL),
                                 refine=refine)
    assert (rp.alloc_policy, rp.order_policy, rp.repacked, rp.refined) == \
        (pp.alloc_policy, pp.order_policy, pp.repacked, pp.refined)
    assert rp.est_makespan_us == pp.est_makespan_us
    assert rp.n_candidates == pp.n_candidates
    assert rp.order == pp.order
    assert _waves(rp.waves) == _waves(pp.waves)
    sim_r = ref_scheduler.simulate_plan(rp, ref_simulator.SimConfig(**HOL))
    sim_p = port_scheduler.simulate_plan(pp, port_simulator.SimConfig(**HOL))
    assert sim_r.makespan_us == sim_p.makespan_us


def test_full_width_cost_only_export_is_the_measured_size():
    rg, pg = _qwen_full_cost_pair()
    assert len(pg) == len(rg) == 556


def test_dtype_normalisation_makes_signatures_equal():
    """A node declaring ``torch.bfloat16`` and one declaring ``jnp.bfloat16``
    sign alike once the reference's dtype spelling is normalised."""
    def build(graph_mod, profiler_mod, dtypes):
        g = graph_mod.OpGraph("typed")
        x = g.add("x", graph_mod.OpKind.INPUT, out_shape=(4, 8),
                  out_dtype=dtypes[0])
        g.add("y", graph_mod.OpKind.GEMM, [x], out_shape=(4, 8),
              out_dtype=dtypes[1], cost=profiler_mod.gemm_cost(4, 8, 8))
        return g
    rg = build(ref_graph, ref_profiler, (jnp.bfloat16, jnp.float32))
    pg = build(port_graph, port_profiler, (torch.bfloat16, torch.float32))
    norm = tuple(row[:3] + (port_graph.dtype_name(n.out_dtype),) + row[4:]
                 for row, n in zip(rg.node_signature(), rg))
    # the reference embeds str(jnp dtype); the port a framework-neutral name
    assert norm == pg.node_signature()
    assert (hashlib.sha1(repr(norm).encode()).hexdigest()
            == pg.signature_digest())
    assert [port_graph.dtype_name(d) for d in
            (torch.bfloat16, jnp.bfloat16, np.dtype("float32"), None)] == \
        ["bfloat16", "bfloat16", "float32", "None"]


@pytest.mark.parametrize("name,spec", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm"),
    ("NVIDIA H100 PCIe", "h100-pcie"),
    ("NVIDIA H100 NVL", "h100-nvl"),
])
def test_hardware_spec_follows_the_device_name(name, spec):
    hw = port_profiler.hardware_for_name(name)
    assert hw.name == spec
    assert hw.machine_balance == hw.peak_flops / hw.hbm_bw


def test_unknown_card_has_no_guessed_spec():
    with pytest.raises(ValueError, match="no hardware spec"):
        port_profiler.hardware_for_name("NVIDIA A100-SXM4-80GB")


def test_analytic_cost_helpers_are_bit_identical():
    for fn, args in [("gemm_cost", (512, 896, 4864)),
                     ("elementwise_cost", (1 << 20, 4, 2, 5.0)),
                     ("norm_cost", (458752,)), ("gather_cost", (512, 896)),
                     ("attention_cost", (1, 512, 512, 14, 64, 2)),
                     ("scan_cost", (2, 64, 128, 16))]:
        r = getattr(ref_profiler, fn)(*args)
        p = getattr(port_profiler, fn)(*args)
        assert dataclasses.asdict(r) == dataclasses.asdict(p), fn
