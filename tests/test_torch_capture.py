"""Capture parity: the port lowers the same plan to the same step list as
the JAX package (routes, op ids, group sizes, slots), its step walk equals
per-op execution, and it has no rescue rung — an armed fused-route fault
site raises out of capture instead of degrading.

Route names pair up as reference ``"pallas"`` ↔ port ``"kernel"`` and
``"vmap"`` ↔ ``"vmap"``.  Walk vs per-op tolerance: fp32, 1e-5.
"""
import dataclasses

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
    capture,
    dag_depth,
    run_sequential_uncompiled,
    run_step,
)
from repro_torch.core.scheduler import autotune, compile_plan, schedule  # noqa: E402
from repro_torch.core.stream_alloc import count_syncs  # noqa: E402
from repro_torch.kernels.grouped_gemm.ops import tile_rows  # noqa: E402
from repro_torch.models.opgraph_export import build_lm_opgraph  # noqa: E402
from repro_torch.models.transformer import init_lm  # noqa: E402
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


# ---- lanes: each step on its plan stream, the fewest waits that order it ----
# The recording puts every lane on a CUDA stream of its own; here, on the
# CPU, the lane plan is checked on its own terms: every cross-lane data edge
# between steps is ordered by lane FIFO order and the waits, no wait is
# implied by the others, and any walk that keeps only those orders computes
# what the single-stream walk computes.

def _qwen_full_depth():
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              n_layers=24)
    params = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    return build_lm_opgraph(cfg, batch=2, seq=8, params=params)


LANE_GRAPHS = {**{name: (lambda n=name: GRAPHS[n]()[1]) for name in GRAPHS},
               "qwen2_smoke_24_layers": _qwen_full_depth}
PLANS = {"opara": lambda g: schedule(g, "opara", "opara"),
         "autotune": lambda g: autotune(g, hw=V5E)}


def _consumed(step):
    return (list(step.arg_slots) if step.route == "call"
            else [s for slots in step.arg_slots for s in slots])


def _cross_edges(steps):
    producer = {s: k for k, st in enumerate(steps) for s in st.out_slots}
    return {(producer[s], k) for k, st in enumerate(steps)
            for s in _consumed(st)
            if s in producer and steps[producer[s]].lane != st.lane}


def _before(steps, skip=None):
    """before[k]: bitmask of the steps ordered before step k by lane FIFO
    order and the waits (leaving out the wait ``skip`` = (p, k))."""
    before, last = [], {}
    for k, st in enumerate(steps):
        mask = 0
        if st.lane in last:
            q = last[st.lane]
            mask |= before[q] | (1 << q)
        for p in st.waits:
            if (p, k) != skip:
                mask |= before[p] | (1 << p)
        before.append(mask)
        last[st.lane] = k
    return before


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("name", sorted(LANE_GRAPHS))
def test_lane_plan_orders_every_cross_lane_edge_with_the_fewest_waits(
        name, plan):
    g = LANE_GRAPHS[name]()
    p = PLANS[plan](g)
    exe = compile_plan(p)
    steps = exe.steps
    assert [s.lane for s in steps] == [p.stream_plan.stream_of[s.op_ids[0]]
                                       for s in steps]
    edges = _cross_edges(steps)
    before = _before(steps)
    assert all(before[k] >> q & 1 for q, k in edges)
    waited = {q for st in steps for q in st.waits}
    for k, st in enumerate(steps):
        assert all(q < k and steps[q].lane != st.lane for q in st.waits)
        assert st.records_event == (k in waited)
        for q in st.waits:      # no wait is implied by FIFO order and the rest
            assert not _before(steps, skip=(q, k))[k] >> q & 1
    stats = exe.lane_stats()
    assert stats["n_cross_edges"] == len(edges)
    assert stats["n_waits"] == sum(len(s.waits) for s in steps) <= len(edges)
    assert stats["n_lanes"] == len({s.lane for s in steps})
    assert stats["n_syncs"] == count_syncs(g, p.stream_plan)
    # the lanes leave step lists and program_stats as the JAX package has them
    assert [s.route for s in steps] == [
        s.route for s in capture(g, p.waves).steps]


def test_some_wave_puts_its_steps_on_two_lanes():
    spans = {}
    for name, build in LANE_GRAPHS.items():
        g = build()
        p = schedule(g, "opara", "opara")
        exe = compile_plan(p)
        wave_of = {op: w.index for w in p.waves.waves for op in w.op_ids}
        lanes = {}
        for s in exe.steps:
            lanes.setdefault(wave_of[s.op_ids[0]], set()).add(s.lane)
        spans[name] = max(map(len, lanes.values()))
    assert max(spans.values()) >= 2, spans
    assert spans["qwen2_smoke_24_layers"] >= 2, spans


@pytest.mark.parametrize("how", ["sequential", "no_stream_plan"])
@pytest.mark.parametrize("name", sorted(LANE_GRAPHS))
def test_sequential_and_unplanned_schedules_hold_one_lane(name, how):
    g = LANE_GRAPHS[name]()
    if how == "sequential":
        exe = compile_plan(schedule(g, "sequential", "topo"))
    else:
        exe = capture(g, schedule(g, "opara", "opara").waves)
    assert exe.lane_stats() == {"n_lanes": 1, "n_waits": 0,
                                "n_cross_edges": 0, "n_syncs": 0}
    assert not any(s.waits or s.records_event or s.cross_slots
                   for s in exe.steps)


def _interleaved_walk(exe, args, rng):
    """The steps in a random order that keeps only each lane's FIFO order
    and the waits, with every slot kept to the end (the device's memory
    lifetimes are the recording's matter): a slot read before it was
    written raises KeyError."""
    steps = exe.steps
    queues = {}
    for k, s in enumerate(steps):
        queues.setdefault(s.lane, []).append(k)
    env = dict(zip(exe.input_slots, args))
    done, order = set(), []
    while len(order) < len(steps):
        ready = [q for q in queues.values()
                 if q and all(p in done for p in steps[q[0]].waits)]
        k = ready[rng.integers(len(ready))].pop(0)
        run_step(steps[k], env)
        done.add(k)
        order.append(k)
    return [env[s] for s in exe.output_slots], order


def _args(g, exe, seed=9):
    """Tokens for the LM exports (smoke vocab 256), fp32 values otherwise."""
    rng = np.random.default_rng(seed)
    args = []
    for name in exe.input_names:
        shape = next(n.out_shape for n in g if n.name == name)
        args.append(torch.from_numpy(rng.integers(0, 256, shape))
                    if name == "tokens" else torch.tensor(
                        rng.standard_normal(shape) * 0.1, dtype=torch.float32))
    return args


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(LANE_GRAPHS))
def test_any_walk_the_waits_allow_equals_the_single_stream_walk(name, seed):
    g = LANE_GRAPHS[name]()
    exe = compile_plan(schedule(g, "opara", "opara"))
    args = _args(g, exe)
    want = exe.fn(*args)
    rng = np.random.default_rng(seed)
    orders = []
    for _ in range(3):
        got, order = _interleaved_walk(exe, args, rng)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        orders.append(order)
    if exe.lane_stats()["n_lanes"] > 1:
        assert any(o != sorted(o) for o in orders)


def test_interleaved_walk_of_qwen2_smoke_matches_the_reference_program():
    rc = dataclasses.replace(ref_config("qwen2-0.5b", smoke=True),
                             dtype=jnp.float32)
    pc = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                             dtype=torch.float32)
    params = make_model(rc).init(jax.random.key(0))
    tparams = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                "cpu")
    rexe = ref_compile(ref_schedule(ref_export(rc, batch=2, seq=8,
                                               params=params), "opara",
                                    "opara"), gemm_kernel="pallas")
    exe = compile_plan(schedule(build_lm_opgraph(pc, batch=2, seq=8,
                                                 params=tparams),
                                "opara", "opara"))
    assert exe.lane_stats()["n_lanes"] > 1
    rng = np.random.default_rng(0)
    for seed in (1, 2):
        tok = np.random.default_rng(seed).integers(0, pc.vocab_size, (2, 8))
        want = rexe({"tokens": jnp.asarray(tok, jnp.int32)})
        got, _ = _interleaved_walk(exe, [torch.from_numpy(tok)], rng)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("edges,is_kernel,want", [
    # a chain of three kernels through an event node
    ([(0, 1), (1, 2), (2, 3)], [1, 0, 1, 1], (3, 3)),
    # a fork into two lanes and a join: two kernels unordered
    ([(0, 1), (0, 2), (1, 3), (2, 3)], [1, 1, 1, 1], (4, 3)),
    # two lanes with no kernel in common, joined by an empty node
    ([(0, 2), (1, 2)], [1, 1, 0], (2, 1)),
])
def test_dag_depth_counts_kernel_nodes_on_the_longest_path(edges, is_kernel,
                                                          want):
    assert dag_depth(dict(enumerate(map(bool, is_kernel))), edges) == want


def test_dag_depth_rejects_a_cycle():
    with pytest.raises(ValueError, match="cycle"):
        dag_depth({0: True, 1: True}, [(0, 1), (1, 0)])
