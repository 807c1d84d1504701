"""Capture parity: the port lowers the same plan to the same step list as
the JAX package (routes, op ids, group sizes, slots), its step walk equals
per-op execution, and it has no rescue rung — an armed fused-route fault
site raises out of capture instead of degrading.

Route names pair up as reference ``"pallas"`` ↔ port ``"kernel"`` and
``"vmap"`` ↔ ``"vmap"``.  Walk vs per-op tolerance: fp32, 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.core import profiler as ref_profiler  # noqa: E402
from repro.core.scheduler import compile_plan as ref_compile  # noqa: E402
from repro.core.scheduler import schedule as ref_schedule  # noqa: E402
from repro.models.model import make_model  # noqa: E402
from repro.models.opgraph_export import build_lm_opgraph as ref_export  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import V5E, Session, SessionConfig  # noqa: E402
from repro_torch.core import graph as port_graph  # noqa: E402
from repro_torch.core import profiler as port_profiler  # noqa: E402
from repro_torch.core.capture import (  # noqa: E402
    PlanValidationError,
    run_sequential_uncompiled,
)
from repro_torch.core.scheduler import compile_plan, schedule  # noqa: E402
from repro_torch.kernels.grouped_gemm.ops import tile_rows  # noqa: E402
from repro_torch.models.opgraph_export import build_lm_opgraph  # noqa: E402
from repro_torch.runtime.faults import FaultInjected, FaultPlan  # noqa: E402

KERNEL_NAMES = {"pallas": "kernel", "vmap": "vmap"}


def _mm(x, w):
    return x @ w


def _mm_b(x, w, b):
    return x @ w + b


def _relu_ref(x):
    return jax.nn.relu(x)


def _relu_port(x):
    return torch.relu(x)


def _sum(*xs):
    return sum(xs)


def _ragged(graph_mod, profiler_mod, tensor, dtype, sizes, k=128, f=128,
            bias=False, seed=3):
    """N parallel matmul branches sharing (K, F) with unequal M."""
    rng = np.random.default_rng(seed)
    g = graph_mod.OpGraph("ragged")
    for i, m in enumerate(sizes):
        x = g.add(f"x{i}", graph_mod.OpKind.INPUT, out_shape=(m, k),
                  out_dtype=dtype)
        consts = (tensor(rng.standard_normal((k, f)) * 0.05),)
        if bias:
            consts += (tensor(rng.standard_normal((f,))),)
        g.add(f"gemm{i}", graph_mod.OpKind.GEMM, [x],
              fn=_mm_b if bias else _mm,
              cost=profiler_mod.gemm_cost(m, k, f, 4),
              fuse_sig=("gemm", k, f, bias), consts=consts,
              payload="matmul", out_shape=(m, f), out_dtype=dtype)
    g.validate()
    return g


def _ragged_pair(sizes, **kw):
    return (_ragged(ref_graph, ref_profiler,
                    lambda a: jnp.asarray(a, jnp.float32), jnp.float32,
                    sizes, **kw),
            _ragged(port_graph, port_profiler,
                    lambda a: torch.tensor(a, dtype=torch.float32),
                    torch.float32, sizes, **kw))


def _inception(graph_mod, profiler_mod, tensor, relu, n_blocks=2, width=4,
               d=32, tokens=8, seed=0):
    """Branchy payload DAG: per block `width` (gemm → relu) branches that
    stack into fused steps, then a sum."""
    rng = np.random.default_rng(seed)
    g = graph_mod.OpGraph("incep")
    cur = g.add("x", graph_mod.OpKind.INPUT, out_shape=(tokens, d))
    for blk in range(n_blocks):
        outs = []
        for b in range(width):
            w = tensor(rng.standard_normal((d, d)) * 0.05)
            c = g.add(f"b{blk}_{b}_gemm", graph_mod.OpKind.GEMM, [cur], fn=_mm,
                      cost=profiler_mod.gemm_cost(tokens, d, d, 4),
                      fuse_sig=("gemm", tokens, d, d), consts=(w,),
                      payload="matmul")
            outs.append(g.add(f"b{blk}_{b}_relu", graph_mod.OpKind.ELEMENTWISE,
                              [c], fn=relu,
                              cost=profiler_mod.elementwise_cost(tokens * d, 4),
                              fuse_sig=("relu", tokens, d)))
        cur = g.add(f"b{blk}_sum", graph_mod.OpKind.ELEMENTWISE, outs, fn=_sum,
                    cost=profiler_mod.elementwise_cost(tokens * d, 4,
                                                       n_in=width))
    g.validate()
    return g


def _inception_pair():
    return (_inception(ref_graph, ref_profiler,
                       lambda a: jnp.asarray(a, jnp.float32), _relu_ref),
            _inception(port_graph, port_profiler,
                       lambda a: torch.tensor(a, dtype=torch.float32),
                       _relu_port))


def _qwen_pair():
    rc = ref_config("qwen2-0.5b", smoke=True)
    params = make_model(rc).init(jax.random.key(0))
    tparams = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                "cpu")
    return (ref_export(rc, batch=2, seq=8, params=params),
            build_lm_opgraph(get_config("qwen2-0.5b", smoke=True), batch=2,
                             seq=8, params=tparams))


GRAPHS = {"qwen2_smoke": _qwen_pair, "inception": _inception_pair,
          "ragged": lambda: _ragged_pair((8, 24, 16)),
          "ragged_bias": lambda: _ragged_pair((0, 40, 8), bias=True)}


def _steps(exe):
    return [(s.route, tuple(s.op_ids), tuple(s.group_sizes),
             tuple(s.free_slots), tuple(s.out_slots), tuple(s.arg_slots))
            for s in exe.steps]


@pytest.mark.parametrize("ref_kernel", ["pallas", "vmap"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_step_lists_are_equal(name, ref_kernel):
    rg, pg = GRAPHS[name]()
    rexe = ref_compile(ref_schedule(rg, "opara", "opara"),
                       gemm_kernel=ref_kernel)
    pexe = compile_plan(schedule(pg, "opara", "opara"),
                        gemm_kernel=KERNEL_NAMES[ref_kernel])
    assert _steps(rexe) == _steps(pexe)
    assert rexe.program_stats() == pexe.program_stats()
    assert rexe.input_ids == pexe.input_ids
    assert rexe.output_ids == pexe.output_ids


def test_qwen2_smoke_lowers_to_the_expected_fused_steps():
    _, pg = _qwen_pair()
    exe = compile_plan(schedule(pg, "opara", "opara"), gemm_kernel="kernel")
    stats = exe.program_stats()
    assert stats["n_branch_gemm"] == 4 and stats["n_vmap"] == 2
    names = sorted(tuple(pg.nodes[o].name for o in s.op_ids)
                   for s in exe.steps if s.route == "branch_gemm")
    assert names == [("L0.gate", "L0.up"), ("L0.wk", "L0.wv"),
                     ("L1.gate", "L1.up"), ("L1.wk", "L1.wv")]


def _inputs(g, seed=9):
    rng = np.random.default_rng(seed)
    return {n.name: torch.tensor(rng.standard_normal(n.out_shape) * 0.1,
                                 dtype=torch.float32)
            for n in g if n.fn is None}


@pytest.mark.parametrize("gemm_kernel", ["auto", "kernel", "vmap"])
@pytest.mark.parametrize("name", ["inception", "ragged", "ragged_bias"])
def test_step_walk_equals_sequential_execution(name, gemm_kernel):
    _, pg = GRAPHS[name]()
    exe = compile_plan(schedule(pg, "opara", "opara"), gemm_kernel=gemm_kernel)
    inputs = _inputs(pg)
    got = exe(inputs)
    want = run_sequential_uncompiled(pg, inputs, exe.output_ids)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert len(exe.degradations) == 0


@pytest.mark.parametrize("sizes", [(8, 24, 16), (0, 40, 8)])
def test_ragged_group_lowers_to_one_grouped_step_with_its_tile_table(sizes):
    _, pg = _ragged_pair(sizes)
    exe = compile_plan(schedule(pg, "opara", "opara"))
    grouped = [s for s in exe.steps if s.route == "grouped_gemm"]
    assert len(grouped) == 1 and exe.program_stats()["n_single"] == 0
    step = grouped[0]
    assert step.group_sizes == tuple(
        pg.nodes[pg.nodes[op].inputs[0]].out_shape[0] for op in step.op_ids)
    assert step.table.dtype == torch.int32
    assert step.table.tolist() == [list(r)
                                   for r in tile_rows(step.group_sizes)]


@pytest.mark.parametrize("site,graph", [("kernel_compile", "inception"),
                                        ("grouped_gemm_route", "ragged")])
def test_armed_fused_route_site_raises_out_of_capture(site, graph):
    _, pg = GRAPHS[graph]()
    plan = schedule(pg, "opara", "opara")
    with pytest.raises(FaultInjected, match=site):
        compile_plan(plan, faults=FaultPlan.single(site))
    # the same site through a Session raises too: no rescue rung
    sess = Session(device="cpu", hw=V5E,
                   fault_plan=FaultPlan.single(site, times=-1))
    with pytest.raises(FaultInjected):
        sess.compile(pg)


def test_corrupt_plan_is_rescheduled_sequential_by_the_session(tmp_path):
    _, pg = _inception_pair()
    with pytest.raises(PlanValidationError):
        compile_plan(schedule(pg, "opara", "opara"),
                     faults=FaultPlan.single("plan_validate"))
    sess = Session(device="cpu", hw=V5E, calib_dir=str(tmp_path),
                   fault_plan=FaultPlan.single("plan_validate"))
    with pytest.warns(UserWarning, match="plan_validate"):
        model = sess.compile(pg)
    assert model.provenance["executable"] == "degraded"
    assert sess.cache_stats()["degraded_routes"] == 1
    inputs = _inputs(pg)
    for a, b in zip(model(inputs), run_sequential_uncompiled(
            pg, inputs, model.executable.output_ids)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_unknown_gemm_kernel_and_input_names_raise():
    _, pg = _inception_pair()
    plan = schedule(pg, "opara", "opara")
    with pytest.raises(ValueError, match="gemm_kernel"):
        compile_plan(plan, gemm_kernel="pallas")
    exe = compile_plan(plan)
    with pytest.raises(KeyError, match="unrecognized"):
        exe({"x": torch.zeros(8, 32), "y": torch.zeros(1)})
