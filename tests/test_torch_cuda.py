"""The port's kernels and CUDA-graph executor on the card.

Every test here needs a Hopper CUDA card and skips without one.  The file
imports neither JAX nor the JAX package, so it runs on a machine with only
PyTorch (the repository's conftest imports JAX; skip it there):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel vs plain bf16 1e-2 (both accumulate in fp32 and round
once to bf16: about one bf16 ulp apart at most); fp32 1e-5 of max|plain|
with TF32 off (summation order only); CUDA-graph replay vs per-op fp32
execution 1e-5; the recording on the plan's lanes vs the same steps
recorded on one stream and vs the eager walk: bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.capture import (  # noqa: E402
    CudaGraphReplay, run_sequential_uncompiled)
from repro_torch.core.graph import OpGraph, OpKind  # noqa: E402
from repro_torch.core.profiler import elementwise_cost, gemm_cost  # noqa: E402
from repro_torch.core.scheduler import compile_plan, schedule  # noqa: E402
from repro_torch.kernels.branch_gemm import ops as bops  # noqa: E402
from repro_torch.kernels.branch_gemm.kernel import (  # noqa: E402
    WGMMA_TILES, branch_gemm_cuda)
from repro_torch.kernels.branch_gemm.ref import branch_gemm_ref  # noqa: E402
from repro_torch.kernels.grouped_gemm import ops as gops  # noqa: E402
from repro_torch.kernels.grouped_gemm.kernel import (  # noqa: E402
    GROUPED_TILES, grouped_gemm_cuda)
from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_kernel_close(got, want):
    if got.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2)
    else:
        scale = want.abs().max().item() if want.numel() else 0.0
        err = (got - want).abs().max().item() if want.numel() else 0.0
        assert err <= 1e-5 * scale


def _route_delta(ops, before):
    return {k: v - before[k] for k, v in ops.launches_by_route.items()
            if v != before[k]}


def _want_route(dtype, k, f):
    if dtype == torch.float32:
        return "fp32"
    return "wgmma" if k % 8 == 0 and f % 8 == 0 else "simple"


# the main path's bf16 shapes (Qwen2 gate||up and wk||wv, RWKV r||k||v||g),
# M off the 128-row tile (77), K off the 64-deep K tile (200), one element
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,m,k,f", [(2, 512, 896, 4864), (2, 512, 896, 128),
                                     (4, 512, 2048, 2048), (3, 77, 200, 136),
                                     (1, 1, 1, 1)])
def test_branch_gemm_kernel_matches_plain(cuda, dtype, n, m, k, f):
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(n, m, k, generator=g, device=cuda).to(dtype)
    w = (torch.randn(n, k, f, generator=g, device=cuda) * k ** -0.5).to(dtype)
    before, by_route = bops.launches, dict(bops.launches_by_route)
    got = bops.branch_gemm(x, w)
    assert bops.launches == before + 1
    assert _route_delta(bops, by_route) == {_want_route(dtype, k, f): 1}
    _assert_kernel_close(got, branch_gemm_ref(x, w))


KIMI_CAPS = (160, 181, 203, 224, 245, 267, 288, 309, 331, 352, 373, 395, 416,
             437, 459, 480)


# a zero-row group and group ends mid-tile; Kimi-K2's routed capacities at a
# reduced K; K off the K tile with F off the 128-column tile
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sizes,k,f", [((0, 37, 512, 5), 896, 4864),
                                       ((8, 24, 16), 128, 128),
                                       ((3, 0, 9), 48, 80),
                                       (KIMI_CAPS, 512, 1024),
                                       ((100, 0, 300, 129, 1), 200, 136)])
def test_grouped_gemm_kernel_matches_plain(cuda, dtype, sizes, k, f):
    g = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn(sum(sizes), k, generator=g, device=cuda).to(dtype)
    w = (torch.randn(len(sizes), k, f, generator=g, device=cuda)
         * k ** -0.5).to(dtype)
    before, by_route = gops.launches, dict(gops.launches_by_route)
    got = gops.grouped_gemm(x, w, sizes, gops.tile_table(sizes, cuda))
    assert gops.launches == before + 1
    assert _route_delta(gops, by_route) == {_want_route(dtype, k, f): 1}
    _assert_kernel_close(got, grouped_gemm_ref(x, w, sizes))


@pytest.mark.parametrize("tiles", WGMMA_TILES)
def test_one_wgmma_tile_is_exact_on_identity_rows_and_a_ramp(cuda, tiles):
    """One 128x128x64 tile: x stacks two 64x64 identities, w is a ramp of
    small integers, so every product is exact and the output must repeat w
    bit for bit; a wrong descriptor offset or swizzle shows as moved rows
    or columns."""
    x = torch.eye(64, device=cuda).repeat(2, 1)[None].to(torch.bfloat16)
    w = (torch.arange(64 * 128, device=cuda) % 97).reshape(1, 64, 128).to(
        torch.bfloat16)
    out = torch.empty(1, 128, 128, device=cuda, dtype=torch.bfloat16)
    branch_gemm_cuda(x, w, out, "wgmma", tiles)
    assert torch.equal(out[0], torch.cat([w[0], w[0]]))


@pytest.mark.parametrize("tiles", WGMMA_TILES)
def test_every_wgmma_branch_tile_matches_plain(cuda, tiles):
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(3, 77, 200, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(3, 200, 136, generator=g, device=cuda) * 0.07
         ).to(torch.bfloat16)
    out = torch.empty(3, 77, 136, device=cuda, dtype=torch.bfloat16)
    branch_gemm_cuda(x, w, out, "wgmma", tiles)
    _assert_kernel_close(out, branch_gemm_ref(x, w))


@pytest.mark.parametrize("tiles", GROUPED_TILES)
def test_every_wgmma_grouped_tile_matches_plain(cuda, tiles):
    sizes = (100, 0, 300, 129, 1)
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(sum(sizes), 200, generator=g, device=cuda).to(
        torch.bfloat16)
    w = (torch.randn(len(sizes), 200, 136, generator=g, device=cuda) * 0.07
         ).to(torch.bfloat16)
    out = torch.empty(sum(sizes), 136, device=cuda, dtype=torch.bfloat16)
    grouped_gemm_cuda(x, w, gops.tile_table(sizes, cuda), out, "wgmma",
                      tiles[1])
    _assert_kernel_close(out, grouped_gemm_ref(x, w, sizes))


def test_branch_gemm_k_edge_reads_zeros_not_the_next_branch(cuda):
    """K = 200 leaves the last K tile 56 rows past K; w[1] holds inf, so a
    K tile that read into the next branch would poison branch 0."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(2, 130, 200, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(2, 200, 136, generator=g, device=cuda) * 0.07
         ).to(torch.bfloat16)
    w[1] = float("inf")
    got = bops.branch_gemm(x, w)
    assert bops.route(x, w) == "wgmma"
    _assert_kernel_close(got[0], branch_gemm_ref(x[:1], w[:1])[0])


def test_grouped_gemm_reads_no_neighbour_into_a_group(cuda):
    """Group 1's rows and w[1] hold inf: group 0's last row tile runs into
    group 1's rows (dropped at the store) and its K edge past K = 200 must
    read zeros, not w[1]."""
    sizes = (100, 60)
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(160, 200, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(2, 200, 136, generator=g, device=cuda) * 0.07
         ).to(torch.bfloat16)
    x[100:] = float("inf")
    w[1] = float("inf")
    got = gops.grouped_gemm(x, w, sizes, gops.tile_table(sizes, cuda))
    _assert_kernel_close(got[:100], grouped_gemm_ref(x[:100], w[:1], (100,)))


def test_simple_route_is_taken_only_where_the_rule_sends_it(cuda):
    x = torch.randn(1, 1, 1, device=cuda).to(torch.bfloat16)
    w = torch.randn(1, 1, 1, device=cuda).to(torch.bfloat16)
    before = dict(bops.launches_by_route)
    bops.branch_gemm(x, w)
    assert _route_delta(bops, before) == {"simple": 1}
    # a contiguous view 2 bytes past an aligned base: TMA cannot read it
    flat = torch.randn(1 + 2 * 16 * 16, device=cuda).to(torch.bfloat16)
    xv = flat[1:].view(2, 16, 16)
    wv = torch.randn(2, 16, 16, device=cuda).to(torch.bfloat16)
    before = dict(bops.launches_by_route)
    got = bops.branch_gemm(xv, wv)
    assert _route_delta(bops, before) == {"simple": 1}
    _assert_kernel_close(got, branch_gemm_ref(xv, wv))
    # the measurement hook runs the simple route at a wgmma shape
    xs = torch.randn(2, 64, 64, device=cuda).to(torch.bfloat16)
    before = dict(bops.launches_by_route)
    got = bops.branch_gemm_simple_bf16(xs, wv.new_ones(2, 64, 32))
    assert _route_delta(bops, before) == {"simple": 1}
    _assert_kernel_close(got, branch_gemm_ref(xs, wv.new_ones(2, 64, 32)))
    before = dict(gops.launches_by_route)
    sizes = (3, 0, 61)
    xg = torch.randn(64, 64, device=cuda).to(torch.bfloat16)
    wg = torch.randn(3, 64, 32, device=cuda).to(torch.bfloat16) * 0.1
    got = gops.grouped_gemm_simple_bf16(xg, wg, sizes)
    assert _route_delta(gops, before) == {"simple": 1}
    _assert_kernel_close(got, grouped_gemm_ref(xg, wg, sizes))


def test_wrappers_raise_on_device_dtype_and_layout(cuda):
    x = torch.zeros(2, 8, 16, device=cuda)
    w = torch.zeros(2, 16, 8, device=cuda)
    with pytest.raises(ValueError, match="devices"):
        bops.branch_gemm(x, w.cpu())
    with pytest.raises(TypeError, match="bf16 or fp32"):
        bops.branch_gemm(x.half(), w.half())
    with pytest.raises(ValueError, match="contiguous"):
        bops.branch_gemm(x[:, ::2], w)
    with pytest.raises(ValueError, match="devices"):
        gops.grouped_gemm(torch.zeros(8, 16, device=cuda), w.cpu(), (4, 4))
    with pytest.raises(TypeError, match="bf16 or fp32"):
        gops.grouped_gemm(torch.zeros(8, 16, device=cuda, dtype=torch.half),
                          w.half(), (4, 4))
    with pytest.raises(ValueError, match="tile table"):
        gops.grouped_gemm(torch.zeros(8, 16, device=cuda), w, (4, 4),
                          gops.tile_table((8, 0), cuda).long())


def _mm(x, w):
    return x @ w


def _mm_b(x, w, b):
    return x @ w + b


def _sum(*xs):
    return sum(xs)


def _branchy(device, width=4, d=64, tokens=32, seed=0, dtype=torch.float32):
    """Per block ``width`` (gemm → relu) branches that stack into fused
    steps, then a sum."""
    rng = np.random.default_rng(seed)
    g = OpGraph("branchy")
    cur = g.add("x", OpKind.INPUT, out_shape=(tokens, d), out_dtype=dtype)
    for blk in range(2):
        outs = []
        for b in range(width):
            w = torch.tensor(rng.standard_normal((d, d)) * 0.05,
                             dtype=dtype, device=device)
            c = g.add(f"b{blk}_{b}_gemm", OpKind.GEMM, [cur], fn=_mm,
                      cost=gemm_cost(tokens, d, d, 4),
                      fuse_sig=("gemm", tokens, d, d), consts=(w,),
                      payload="matmul")
            outs.append(g.add(f"b{blk}_{b}_relu", OpKind.ELEMENTWISE, [c],
                              fn=torch.relu,
                              cost=elementwise_cost(tokens * d, 4),
                              fuse_sig=("relu", tokens, d)))
        cur = g.add(f"b{blk}_sum", OpKind.ELEMENTWISE, outs, fn=_sum,
                    cost=elementwise_cost(tokens * d, 4, n_in=width))
    return g


def _ragged(device, sizes=(8, 24, 16), k=128, f=128, bias=False, seed=3,
            dtype=torch.float32):
    rng = np.random.default_rng(seed)
    g = OpGraph("ragged")
    for i, m in enumerate(sizes):
        x = g.add(f"x{i}", OpKind.INPUT, out_shape=(m, k), out_dtype=dtype)
        consts = (torch.tensor(rng.standard_normal((k, f)) * 0.05,
                               dtype=dtype, device=device),)
        if bias:
            consts += (torch.tensor(rng.standard_normal((f,)),
                                    dtype=dtype, device=device),)
        g.add(f"gemm{i}", OpKind.GEMM, [x], fn=_mm_b if bias else _mm,
              cost=gemm_cost(m, k, f, 4), fuse_sig=("gemm", k, f, bias),
              consts=consts, payload="matmul", out_shape=(m, f),
              out_dtype=dtype)
    return g


GRAPHS = {"branchy": _branchy, "ragged": _ragged,
          "ragged_bias": lambda d: _ragged(d, (0, 40, 8), bias=True),
          "branchy_bf16": lambda d: _branchy(d, dtype=torch.bfloat16),
          "ragged_bf16": lambda d: _ragged(d, (0, 200, 37, 129),
                                           dtype=torch.bfloat16)}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_cuda_graph_replay_matches_per_op_execution(cuda, name):
    """Replay against per-op execution (cuBLAS; fp32 1e-5, bf16 1e-2), and
    bit-equal to the eager step walk: the graph's baked tensor maps read
    what maps encoded at each eager launch read."""
    g = GRAPHS[name](cuda)
    exe = compile_plan(schedule(g, "opara", "opara"))
    rng = np.random.default_rng(1)
    requests = [{n.name: torch.tensor(rng.standard_normal(n.out_shape) * 0.1,
                                      dtype=n.out_dtype or torch.float32,
                                      device=cuda)
                 for n in g if n.fn is None} for _ in range(2)]
    routes = dict(bops.launches_by_route), dict(gops.launches_by_route)
    outs = [exe(r) for r in requests]          # record, then replay
    taken = set(_route_delta(bops, routes[0])) | set(
        _route_delta(gops, routes[1]))
    bf16 = name.endswith("_bf16")
    assert taken == ({"wgmma"} if bf16 else {"fp32"})
    stats = exe.program_stats()
    recorded = exe.replay.recorded_launches
    assert {k: recorded[k] for k in ("branch_gemm", "grouped_gemm")} == {
        "branch_gemm": int(stats["n_branch_gemm"]),
        "grouped_gemm": int(stats["n_grouped_gemm"])}
    assert not any(n for k, n in recorded.items()
                   if k not in ("branch_gemm", "grouped_gemm"))
    assert stats["n_branch_gemm"] + stats["n_grouped_gemm"] >= 1
    tol = 1e-2 if bf16 else 1e-5
    # clones: the second request did not overwrite the first one's result
    for got, inputs in zip(outs, requests):
        want = run_sequential_uncompiled(g, inputs, exe.output_ids)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=tol, atol=tol)
        eager = exe.call_uncompiled(inputs)
        assert all(torch.equal(a, b) for a, b in zip(got, eager))
    with pytest.raises(ValueError, match="recorded"):
        exe({k: torch.cat([v, v]) for k, v in requests[0].items()})


def _inception(device, widths=(64, 64, 96, 160), d=128, tokens=64, seed=4,
               dtype=torch.float32):
    """Two blocks of parallel (gemm d→f → relu → gemm f→d) branches, then a
    sum: branches of one width stack into fused steps, the others stay
    single steps on lanes of their own."""
    rng = np.random.default_rng(seed)
    g = OpGraph("inception")
    cur = g.add("x", OpKind.INPUT, out_shape=(tokens, d), out_dtype=dtype)
    for blk in range(2):
        outs = []
        for b, f in enumerate(widths):
            h = cur
            for i, (k, n) in enumerate(((d, f), (f, d))):
                w = torch.tensor(rng.standard_normal((k, n)) * k ** -0.5,
                                 dtype=dtype, device=device)
                h = g.add(f"b{blk}_{b}_gemm{i}", OpKind.GEMM, [h], fn=_mm,
                          cost=gemm_cost(tokens, k, n, 4),
                          fuse_sig=("gemm", tokens, k, n), consts=(w,),
                          payload="matmul", out_shape=(tokens, n),
                          out_dtype=dtype)
                if i == 0:
                    h = g.add(f"b{blk}_{b}_relu", OpKind.ELEMENTWISE, [h],
                              fn=torch.relu,
                              cost=elementwise_cost(tokens * f, 4),
                              fuse_sig=("relu", tokens, f),
                              out_shape=(tokens, f), out_dtype=dtype)
            outs.append(h)
        cur = g.add(f"b{blk}_sum", OpKind.ELEMENTWISE, outs, fn=_sum,
                    cost=elementwise_cost(tokens * d, 4, n_in=len(widths)),
                    out_shape=(tokens, d), out_dtype=dtype)
    return g


LANE_GRAPHS = {**GRAPHS, "inception": _inception,
               "inception_bf16": lambda d: _inception(d, dtype=torch.bfloat16)}


@pytest.mark.parametrize("name", sorted(LANE_GRAPHS))
def test_lane_recording_is_concurrent_and_bit_equal_to_one_stream(cuda, name):
    """The recording with each lane on its own stream: bit-equal to the
    same steps recorded on one stream and to the eager walk, request after
    request; its graph has two unordered kernels wherever the plan puts
    steps on two lanes, and the one-stream recording is a chain."""
    g = LANE_GRAPHS[name](cuda)
    exe = compile_plan(schedule(g, "opara", "opara"))
    lanes = exe.lane_stats()
    if name.startswith("inception"):
        assert lanes["n_lanes"] > 1 and lanes["n_waits"] >= 1
    rng = np.random.default_rng(2)
    requests = [{n.name: torch.tensor(rng.standard_normal(n.out_shape) * 0.1,
                                      dtype=n.out_dtype or torch.float32,
                                      device=cuda)
                 for n in g if n.fn is None} for _ in range(2)]
    outs = [exe(r) for r in requests]          # record, then replay
    replay = exe.replay
    assert (replay.n_lanes, replay.n_waits) == (lanes["n_lanes"],
                                                lanes["n_waits"])
    one = CudaGraphReplay(exe.fn, [requests[0][n] for n in exe.input_names])
    assert (one.n_lanes, one.n_waits) == (1, 0)
    for got, inputs in zip(outs, requests):
        single = one([inputs[n] for n in exe.input_names])
        eager = exe.call_uncompiled(inputs)
        assert all(torch.equal(a, b) for a, b in zip(got, single))
        assert all(torch.equal(a, b) for a, b in zip(got, eager))
    # clones: the second request did not overwrite the first one's result
    assert not all(torch.equal(a, b) for a, b in zip(*outs))
    assert replay.pool_bytes > 0 and one.pool_bytes > 0
    nodes, depth = replay.kernel_dag()
    assert nodes >= len(exe.steps)
    assert (depth < nodes) if lanes["n_lanes"] > 1 else (depth == nodes)
    assert one.kernel_dag() == (nodes, nodes)
    with pytest.raises(ValueError, match="recorded"):
        exe({k: torch.cat([v, v]) for k, v in requests[0].items()})


REPLAY_SPANS = ("forward", "replay.copy_in", "replay.device",
                "replay.submit", "replay.copy_out")
RECORD_SPANS = ("record", "record.warmup_walk", "record.capture",
                "record.pool_bytes", "record.instantiate")


@pytest.mark.parametrize("name", ["inception", "inception_bf16"])
def test_traced_replay_is_bit_equal_and_adds_no_synchronize(cuda, name):
    """With the program's tracing on, a lane recording's replays are
    bit-equal to the replays with it off, kineto's trace holds each call's
    replay spans, and no call issues a device or stream synchronize:
    ``replay.device`` is read from its events once the caller has
    synchronised on its own.  A first call under tracing records the
    ``record`` span and its four stages."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace

    g = LANE_GRAPHS[name](cuda)
    exe = compile_plan(schedule(g, "opara", "opara"))
    rng = np.random.default_rng(5)
    requests = [{n.name: torch.tensor(rng.standard_normal(n.out_shape) * 0.1,
                                      dtype=n.out_dtype or torch.float32,
                                      device=cuda)
                 for n in g if n.fn is None} for _ in range(3)]
    off = [exe(r) for r in requests]           # record, then replay
    torch.cuda.synchronize()
    trace.reset()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            on = [exe(r) for r in requests]
        torch.cuda.synchronize()
        spans = trace.records()
        trace.reset()
        fresh = compile_plan(schedule(g, "opara", "opara"))
        first = fresh(requests[0])
        torch.cuda.synchronize()
        recorded = trace.summary()
    finally:
        trace.enable(False)
        trace.reset()
    for got, want in zip(on, off):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(first, off[0]))
    # kineto's host events (it also lays each span over the device's
    # timeline, as a user annotation); the profiler's own stop
    # synchronises, outside every call
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]
    names = [n for n, _, _ in host]
    calls = [(a, b) for n, a, b in host if n == "forward"]
    assert len(calls) == len(requests)
    assert not [n for n, a, _ in host
                if n in ("cudaDeviceSynchronize", "cudaStreamSynchronize")
                and any(c0 <= a <= c1 for c0, c1 in calls)]
    assert "cudaGraphLaunch" in names
    for span_name in REPLAY_SPANS:
        assert names.count(span_name) == len(requests), span_name
        assert sum(s.name == span_name for s in spans) == len(requests)
    device = {s.id: s for s in spans if s.name == "replay.device"}
    assert all(s.device_ns is not None and s.device_ns > 0
               for s in device.values())
    assert all(s.parent in device for s in spans
               if s.name == "replay.submit")
    assert {s.forward for s in spans} == {s.id for s in spans
                                          if s.name == "forward"}
    for span_name in RECORD_SPANS:
        assert recorded[span_name]["calls"] == 1, span_name
    assert recorded["replay.device"]["device_calls"] == 1


# ---- normalisation and attention kernels ------------------------------------
# Tolerances as above: bf16 1e-2, fp32 1e-5 of max|plain|.  The attention
# kernels' plain versions round differently inside (the flash plain version
# keeps probabilities in fp32; the kernels round them to the value dtype
# after an online softmax), which stays within one bf16 ulp of the output.

from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.paged_decode import ops as pops  # noqa: E402
from repro_torch.kernels.paged_decode.ref import paged_decode_attention_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402


def _randn(cuda, seed, *shape, dtype=torch.float32, scale=1.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=cuda) * scale).to(dtype)


# every width the registered models normalise (Qwen2-0.5B 896, RWKV6-1.6B
# 2048, Kimi-K2 and DeepSeek-V3 7168, DeepSeek-V3's q_norm 1536 and kv_norm
# 512) at a prefill's 512 rows and a decode tick's 8; odd widths (the simple
# route in bf16); more rows than one resident wave (teams stride over rows)
NORM_CASES = [(n, d) for d in (896, 2048, 7168, 1536, 512) for n in (512, 8)]
NORM_CASES += [(3, 14), (5, 100), (40000, 64)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d", NORM_CASES)
def test_rmsnorm_kernel_matches_plain(cuda, dtype, n, d):
    x = _randn(cuda, n, n, d, dtype=dtype)
    scale = _randn(cuda, d, d, dtype=dtype)
    before, by_route = rops.launches, dict(rops.launches_by_route)
    got = rops.rmsnorm(x, scale)
    assert rops.launches == before + 1
    want = "onepass" if d * x.element_size() % 16 == 0 else "simple"
    assert _route_delta(rops, by_route) == {want: 1}
    _assert_kernel_close(got, rmsnorm_ref(x, scale))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d", [(512, 896), (8, 7168)])
def test_rmsnorm_simple_route_matches_plain_and_the_onepass_route(cuda,
                                                                  dtype, n,
                                                                  d):
    x = _randn(cuda, n, n, d, dtype=dtype)
    scale = _randn(cuda, d, d, dtype=dtype)
    by_route = dict(rops.launches_by_route)
    got = rops.rmsnorm_simple(x, scale)
    assert _route_delta(rops, by_route) == {"simple": 1}
    _assert_kernel_close(got, rmsnorm_ref(x, scale))
    _assert_kernel_close(got, rops.rmsnorm(x, scale))
    # a view one element past an aligned base takes the simple route
    xv = _randn(cuda, 9, 1 + n * d, dtype=dtype)[1:].view(n, d)
    by_route = dict(rops.launches_by_route)
    _assert_kernel_close(rops.rmsnorm(xv, scale), rmsnorm_ref(xv, scale))
    assert _route_delta(rops, by_route) == {"simple": 1}


# Qwen2-0.5B's 512-token prefill, D = 14 (simple route in bf16), a window
# of 32, D = 128 at S = 130, a window of 1, Kimi-K2's 64/8 heads of 112 at
# S = 200, an S edge at S = 77 with D = 64
FLASH_CASES = [(1, 512, 14, 2, 64, 0), (2, 77, 4, 2, 14, 0),
               (1, 200, 4, 1, 64, 32), (1, 130, 2, 2, 128, 0),
               (1, 90, 4, 2, 64, 1), (1, 200, 64, 8, 112, 0),
               (2, 77, 4, 2, 64, 0)]


def _want_flash_route(dtype, d):
    if dtype == torch.float32:
        return "fp32"
    return "wgmma" if d % 16 == 0 else "simple"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,kvh,d,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, s, h, kvh, d,
                                              window):
    q = _randn(cuda, 1, b, s, h, d, dtype=dtype)
    k = _randn(cuda, 2, b, s, kvh, d, dtype=dtype)
    v = _randn(cuda, 3, b, s, kvh, d, dtype=dtype)
    before, by_route = fops.launches, dict(fops.launches_by_route)
    got = fops.flash_attention(q, k, v, causal=True, window=window)
    assert fops.launches == before + 1
    assert _route_delta(fops, by_route) == {_want_flash_route(dtype, d): 1}
    _assert_kernel_close(got, flash_attention_ref(q, k, v, True, window))


def test_flash_attention_reads_strided_operands(cuda):
    """q, k, v as views into one fused projection (non-contiguous heads)."""
    qkv = _randn(cuda, 4, 2, 70, 8, 64, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = fops.flash_attention(q, k, v)
    _assert_kernel_close(got, flash_attention_ref(q, k, v))


@pytest.mark.parametrize("d", [64, 112])
def test_flash_wgmma_reads_no_neighbour_head_batch_row_or_row_past_s(cuda,
                                                                     d):
    """The operands are views with inf in the heads and batch rows beside
    them and in the rows past S (= T): a TMA box that read any of them
    would make the output non-finite."""
    s, h, kvh = 150, 8, 2
    inf = float("inf")
    big_q = torch.full((3, s + 20, h + 2, d), inf, dtype=torch.bfloat16,
                       device=cuda)
    big_k = torch.full((3, s + 20, kvh + 2, d), inf, dtype=torch.bfloat16,
                       device=cuda)
    big_v = torch.full_like(big_k, inf)
    q = big_q[1:2, :s, 1:h + 1]
    k, v = big_k[1:2, :s, 1:kvh + 1], big_v[1:2, :s, 1:kvh + 1]
    q.copy_(_randn(cuda, 12, 1, s, h, d, dtype=torch.bfloat16))
    k.copy_(_randn(cuda, 13, 1, s, kvh, d, dtype=torch.bfloat16))
    v.copy_(_randn(cuda, 14, 1, s, kvh, d, dtype=torch.bfloat16))
    assert fops.route(q, k, v) == "wgmma"
    got = fops.flash_attention(q, k, v, causal=True, window=40)
    assert bool(torch.isfinite(got).all())
    _assert_kernel_close(got, flash_attention_ref(q, k, v, True, 40))


@pytest.mark.parametrize("s,h,kvh,d,window", [(512, 14, 2, 64, 0),
                                              (200, 64, 8, 112, 0),
                                              (130, 2, 2, 128, 17)])
def test_flash_wgmma_route_agrees_with_the_simple_route(cuda, s, h, kvh, d,
                                                        window):
    q = _randn(cuda, 15, 1, s, h, d, dtype=torch.bfloat16)
    k = _randn(cuda, 16, 1, s, kvh, d, dtype=torch.bfloat16)
    v = _randn(cuda, 17, 1, s, kvh, d, dtype=torch.bfloat16)
    by_route = dict(fops.launches_by_route)
    got = fops.flash_attention(q, k, v, causal=True, window=window)
    simple = fops.flash_attention_simple_bf16(q, k, v, causal=True,
                                              window=window)
    assert _route_delta(fops, by_route) == {"wgmma": 1, "simple": 1}
    _assert_kernel_close(got, simple)


# Qwen2-0.5B's 8-slot tick, D = 14 (the simple route in bf16), one KV head,
# Kimi-K2's 64/8 heads of 112, D = 40 (K padded to 48 in the mma route, a
# last 8-column block of V), 16 heads a KV head at D = 128
DECODE_CASES = [(8, 14, 2, 1024, 64), (3, 4, 2, 200, 14), (2, 7, 1, 64, 64),
                (8, 64, 8, 1024, 112), (2, 6, 2, 100, 40),
                (2, 16, 1, 300, 128)]


def _want_decode_route(dtype, d):
    if dtype == torch.float32:
        return "fp32"
    return "mma" if d % 8 == 0 else "simple"


def _decode_operands(cuda, dtype, b, h, kvh, t, d):
    q = _randn(cuda, 5, b, h, d, dtype=dtype)
    k = _randn(cuda, 6, b, t, kvh, d, dtype=dtype)
    v = _randn(cuda, 7, b, t, kvh, d, dtype=dtype)
    pos = torch.arange(b, device=cuda) * (t // max(b, 1)) + t // (2 * b)
    k_pos = torch.arange(t, device=cuda)[None]
    valid = k_pos <= pos[:, None]
    valid[0] &= k_pos[0] > pos[0] - 40            # a windowed row
    return q, k, v, valid


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,kvh,t,d", DECODE_CASES)
def test_decode_attention_kernel_matches_plain(cuda, dtype, b, h, kvh, t, d):
    q, k, v, valid = _decode_operands(cuda, dtype, b, h, kvh, t, d)
    before, by_route = dops.launches, dict(dops.launches_by_route)
    got = dops.decode_attention(q, k, v, valid)
    assert dops.launches == before + 1
    assert _route_delta(dops, by_route) == {_want_decode_route(dtype, d): 1}
    _assert_kernel_close(got, decode_attention_ref(q, k, v, valid))


@pytest.mark.parametrize("b,h,kvh,t,d", [c for c in DECODE_CASES
                                         if c[-1] % 8 == 0])
def test_decode_mma_route_agrees_with_the_simple_route(cuda, b, h, kvh, t, d):
    """The mma route against the routine it replaced, in the same call, on
    the slab and through pages (4 positions a page)."""
    q, k, v, valid = _decode_operands(cuda, torch.bfloat16, b, h, kvh, t, d)
    by_route = dict(dops.launches_by_route)
    got = dops.decode_attention(q, k, v, valid)
    simple = dops.decode_attention_simple_bf16(q, k, v, valid)
    assert _route_delta(dops, by_route) == {"mma": 1, "simple": 1}
    _assert_kernel_close(got, simple)
    ps = 4
    maxp = -(-t // ps)
    pad = maxp * ps - t
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)).reshape(
        b * maxp, ps, kvh, d)
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).reshape(
        b * maxp, ps, kvh, d)
    bt = torch.arange(b * maxp, dtype=torch.int32, device=cuda).reshape(
        b, maxp)
    starts = torch.argmax(valid.int(), dim=1).to(torch.int32)
    lengths = (valid.sum(1) + starts).to(torch.int32)
    by_route = dict(pops.launches_by_route)
    got_p = pops.paged_decode_attention(q, kp, vp, bt, lengths, starts)
    simple_p = pops.paged_decode_simple_bf16(q, kp, vp, bt, lengths, starts)
    assert _route_delta(pops, by_route) == {"mma": 1, "simple": 1}
    _assert_kernel_close(got_p, simple_p)
    if pad == 0:
        assert torch.equal(got_p, got)


@pytest.mark.parametrize("d", [64, 112])
def test_decode_mma_reads_no_masked_row_neighbour_head_or_batch_row(cuda, d):
    """The slab is a view with inf in the KV heads and batch rows beside it
    and in every masked position: a copy that read any of them would make
    the output non-finite."""
    b, h, kvh, t = 3, 8, 2, 150
    inf = float("inf")
    big = torch.full((b + 2, t, kvh + 2, d), inf, dtype=torch.bfloat16,
                     device=cuda)
    big_v = torch.full_like(big, inf)
    k, v = big[1:b + 1, :, 1:kvh + 1], big_v[1:b + 1, :, 1:kvh + 1]
    valid = torch.arange(t, device=cuda)[None] < torch.tensor(
        [[37], [150], [90]], device=cuda)
    valid[2, :20] = False                          # a windowed row
    keep = valid[:, :, None, None].expand_as(k)
    k.copy_(torch.where(keep, _randn(cuda, 23, b, t, kvh, d,
                                     dtype=torch.bfloat16), k))
    v.copy_(torch.where(keep, _randn(cuda, 24, b, t, kvh, d,
                                     dtype=torch.bfloat16), v))
    q = _randn(cuda, 25, b, h, d, dtype=torch.bfloat16)
    assert dops.route(q, k, v) == "mma"
    got = dops.decode_attention(q, k, v, valid)
    assert bool(torch.isfinite(got).all())
    clean_k = torch.where(keep, k, torch.zeros_like(k))
    clean_v = torch.where(keep, v, torch.zeros_like(v))
    _assert_kernel_close(got, decode_attention_ref(q, clean_k, clean_v,
                                                   valid))


def _paged_case(cuda, dtype, d=64, ps=16):
    """Pages with a shuffled table: row 0 windowed (with 16-position pages
    its leading pages are fully masked; with 5-position ones the window
    start clamps to 0), row 1's last table entries on the null page, row 2
    a single partial page."""
    b, h, kvh, maxp = 3, 14, 2, 12
    n_pages = 1 + b * maxp
    q = _randn(cuda, 8, b, h, d, dtype=dtype)
    kp = _randn(cuda, 9, n_pages, ps, kvh, d, dtype=dtype)
    vp = _randn(cuda, 10, n_pages, ps, kvh, d, dtype=dtype)
    g = torch.Generator().manual_seed(11)
    bt = (torch.randperm(n_pages - 1, generator=g)[:b * maxp] + 1).reshape(
        b, maxp).to(torch.int32)
    bt[1, 7:] = 0
    bt = bt.to(cuda)
    first = min(170, maxp * ps - 10)
    lengths = torch.tensor([first, 7 * ps - 3, 5], dtype=torch.int32,
                           device=cuda)
    starts = torch.tensor([max(0, first - 64), 0, 0], dtype=torch.int32,
                          device=cuda)
    return q, kp, vp, bt, lengths, starts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,ps", [(64, 16), (14, 16), (64, 5)])
def test_paged_decode_kernel_matches_plain_and_dense(cuda, dtype, d, ps):
    """Paged and dense on one route: with ps = 5 a split (a whole number of
    16-position tiles) is not a whole number of pages."""
    q, kp, vp, bt, lengths, starts = _paged_case(cuda, dtype, d, ps)
    before, by_route = pops.launches, dict(pops.launches_by_route)
    got = pops.paged_decode_attention(q, kp, vp, bt, lengths, starts)
    assert pops.launches == before + 1
    assert _route_delta(pops, by_route) == {_want_decode_route(dtype, d): 1}
    _assert_kernel_close(got, paged_decode_attention_ref(q, kp, vp, bt,
                                                         lengths, starts))
    # the dense kernel on the gathered slab sums the same positions in the
    # same order: bit-equal
    b, maxp = bt.shape
    kd = kp[bt.long()].reshape(b, maxp * ps, *kp.shape[2:])
    vd = vp[bt.long()].reshape(b, maxp * ps, *vp.shape[2:])
    posn = torch.arange(maxp * ps, device=cuda)[None]
    valid = (posn < lengths[:, None]) & (posn >= starts[:, None])
    by_route = dict(dops.launches_by_route)
    assert torch.equal(got, dops.decode_attention(q, kd, vd, valid))
    assert _route_delta(dops, by_route) == {_want_decode_route(dtype, d): 1}


def test_attention_wrappers_raise_on_device_dtype_and_layout(cuda):
    x = torch.zeros(4, 64, device=cuda)
    with pytest.raises(ValueError, match="devices"):
        rops.rmsnorm(x, torch.ones(64))
    with pytest.raises(TypeError, match="bf16 or fp32"):
        rops.rmsnorm(x.half(), torch.ones(64, device=cuda).half())
    with pytest.raises(ValueError, match="contiguous"):
        rops.rmsnorm(torch.zeros(4, 128, device=cuda)[:, ::2],
                     torch.ones(64, device=cuda))
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    kv = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="devices"):
        fops.flash_attention(q, kv.cpu(), kv.cpu())
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fops.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros(1, 8, 4, 128, device=cuda)
        fops.flash_attention(wide[..., ::2], kv, kv)
    with pytest.raises(ValueError, match="head dims"):
        big = torch.zeros(1, 8, 2, 192, device=cuda)
        fops.flash_attention(big, big, big)
    qd = torch.zeros(2, 4, 64, device=cuda)
    cache = torch.zeros(2, 32, 2, 64, device=cuda)
    valid = torch.ones(2, 32, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="devices"):
        dops.decode_attention(qd, cache, cache, valid.cpu())
    with pytest.raises(TypeError, match="bool"):
        dops.decode_attention(qd, cache, cache, valid.int())
    with pytest.raises(TypeError, match="bf16 or fp32"):
        dops.decode_attention(qd.half(), cache.half(), cache.half(), valid)
    pages = torch.zeros(5, 16, 2, 64, device=cuda)
    bt = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    lengths = torch.full((2,), 20, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        pops.paged_decode_attention(qd, pages, pages, bt.long(), lengths)
    with pytest.raises(ValueError, match="devices"):
        pops.paged_decode_attention(qd, pages, pages, bt.cpu(), lengths)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        pops.paged_decode_attention(qd.half(), pages.half(), pages.half(), bt,
                                    lengths)


def _small_engine(cuda, paged):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import AdmissionConfig, InferenceEngine
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              d_model=128, n_heads=4, n_kv_heads=2, d_head=32)
    model = Model(cfg, use_kernels=True)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    return InferenceEngine(model, params, max_slots=4, max_len=96, seed=1,
                           admission=AdmissionConfig(policy="edf",
                                                     preemption=True),
                           paged_kv=paged, page_size=16)


def _small_trace():
    rng = np.random.default_rng(5)
    return [dict(rid=i, prompt=rng.integers(1, 256, int(n)).tolist(),
                 priority=2 if i % 3 == 2 else 0,
                 ttl=14 if i % 3 == 2 else None)
            for i, n in enumerate(rng.integers(3, 40, 9))]


def _serve(engine, trace):
    from repro_torch.serving import Request
    for i, spec in enumerate(trace):
        engine.submit(Request(max_tokens=10, **spec))
        if i % 2:
            engine.step()
    return {r.rid: (r.state.value, tuple(r.output)) for r in engine.run(400)}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_graph_tick_is_bit_equal_to_the_eager_tick(cuda, paged):
    from repro_torch.serving import Request
    engine = _small_engine(cuda, paged)
    for i in range(3):
        engine.submit(Request(rid=i, prompt=[5 + i, 9, 2, 7], max_tokens=30))
    for _ in range(5):
        engine.step()
    values = [engine.last_token, engine.pos]
    if paged:
        values.append(engine._block_table_array())
    graph_logits = engine._step(values).clone()
    assert engine.decode_graph.graph is not None
    recorded = engine.decode_graph.recorded_launches
    assert recorded["rmsnorm"] > 0
    assert recorded["paged_decode" if paged else "decode_attention"] > 0
    if paged:
        eager = engine.model.paged_decode(
            engine.params, engine._on_device(engine.last_token, torch.long),
            engine.caches,
            engine._on_device(engine._block_table_array(), torch.int32),
            engine._on_device(engine.pos, torch.int32))[0]
    else:
        eager = engine._eager_decode()
    assert torch.equal(graph_logits, eager)


def test_paged_engine_equals_dense_engine_bf16(cuda):
    trace = _small_trace()
    dense = _serve(_small_engine(cuda, False), trace)
    paged_engine = _small_engine(cuda, True)
    paged = _serve(paged_engine, trace)
    assert paged == dense
    assert all(state != "pending" for state, _ in paged.values())
    assert paged_engine.fault_stats["watchdog_fallbacks"] == 0
    assert paged_engine.fault_stats["paged_decode_fallbacks"] == 0


# ---- the C7 repair: a decode row with no attended position -------------------

def test_decode_kernels_average_v_on_a_row_with_no_attended_position(cuda):
    """The plain versions (and the JAX package) return V averaged over every
    position of such a row (null pages included); so must the kernels."""
    for dtype in (torch.bfloat16, torch.float32):
        q = _randn(cuda, 20, 3, 4, 64, dtype=dtype)
        k = _randn(cuda, 21, 3, 200, 2, 64, dtype=dtype)
        v = _randn(cuda, 22, 3, 200, 2, 64, dtype=dtype)
        valid = torch.arange(200, device=cuda)[None] < torch.tensor(
            [[0], [37], [0]], device=cuda)
        by_route = dict(dops.launches_by_route)
        got = dops.decode_attention(q, k, v, valid)
        assert _route_delta(dops, by_route) == {
            _want_decode_route(dtype, 64): 1}
        want = decode_attention_ref(q, k, v, valid)
        _assert_kernel_close(got, want)
        mean = v[0].float().mean(0)                       # [KVH, D]
        _assert_kernel_close(got[0],
                             mean.repeat_interleave(2, dim=0).to(dtype))
        qp, kp, vp, bt, lengths, starts = _paged_case(cuda, dtype)
        lengths[1] = 0                     # row 1: nothing attended
        starts[2] = lengths[2]             # row 2: an empty window
        by_route = dict(pops.launches_by_route)
        got = pops.paged_decode_attention(qp, kp, vp, bt, lengths, starts)
        assert _route_delta(pops, by_route) == {
            _want_decode_route(dtype, 64): 1}
        _assert_kernel_close(got, paged_decode_attention_ref(
            qp, kp, vp, bt, lengths, starts))


# ---- moe_gemm and rwkv6 --------------------------------------------------------

from repro_torch.kernels.moe_gemm import ops as mops  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_mlp_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wops  # noqa: E402
from repro_torch.kernels.rwkv6.ref import rwkv6_ref  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e,c,d,f", [(4, 1, 256, 128), (3, 13, 200, 136),
                                     (2, 37, 72, 40), (5, 0, 64, 64),
                                     (1, 7, 7168, 64)])
def test_moe_gemm_kernel_matches_plain(cuda, dtype, e, c, d, f):
    buf = _randn(cuda, 30, e, c, d, dtype=dtype, scale=0.5)
    gate = _randn(cuda, 31, e, d, f, dtype=dtype, scale=d ** -0.5)
    up = _randn(cuda, 32, e, d, f, dtype=dtype, scale=d ** -0.5)
    down = _randn(cuda, 33, e, f, d, dtype=dtype, scale=f ** -0.5)
    before = mops.launches
    got = mops.moe_mlp(buf, gate, up, down)
    assert mops.launches == before + (1 if c else 0)
    assert got.shape == buf.shape and got.dtype == dtype
    _assert_kernel_close(got, moe_mlp_ref(buf, gate, up, down))


def _moe_case(cuda, e, c, d, f, rows=None, dtype=torch.bfloat16, seed=0):
    """Expert operands; with ``rows`` (expert indices) only row 0 of those
    experts (the last row for one expert) is nonzero, as the dispatch
    leaves the capacity buffers."""
    buf = _randn(cuda, 50 + seed, e, c, d, dtype=dtype, scale=0.5)
    if rows is not None:
        keep = torch.zeros(e, c, 1, dtype=dtype, device=cuda)
        keep[torch.as_tensor(rows, device=cuda).long(),
             c - 1 if len(rows) == 1 else 0] = 1
        buf = buf * keep
    gate = _randn(cuda, 51 + seed, e, d, f, dtype=dtype, scale=d ** -0.5)
    up = _randn(cuda, 52 + seed, e, d, f, dtype=dtype, scale=d ** -0.5)
    down = _randn(cuda, 53 + seed, e, f, d, dtype=dtype, scale=f ** -0.5)
    return buf, gate, up, down


def _tick_rows(cuda, e, tokens=8, top_k=8):
    """The experts a decode tick's tokens route to (random top-k)."""
    g = torch.Generator(device=cuda).manual_seed(e)
    return torch.unique(torch.rand(tokens, e, generator=g, device=cuda)
                        .topk(top_k, dim=-1).indices).tolist()


def _assert_empty_rows_are_positive_zero(buf, got):
    empty = (buf == 0).flatten(1).all(dim=1)
    rows = got[empty]
    assert bool((rows == 0).all()) and not bool(torch.signbit(rows).any())


# the tick's occupancy (8 tokens' top-8 over 384 experts at C = 1) at reduced
# widths, a prefill's C = 13 with some experts empty, every expert empty,
# only the last expert with one row, C past one row tile (40) and past 64
# (row chunks), K and M off the 64-wide tiles
MOE_WGMMA_CASES = [
    ("tick", (384, 1, 256, 128), "tick"),
    ("prefill C=13", (16, 13, 512, 256), [0, 3, 4, 9, 15]),
    ("all empty", (32, 1, 256, 128), []),
    ("last expert one row", (32, 13, 256, 128), [31]),
    ("C=40", (4, 40, 128, 64), None),
    ("C=70", (3, 70, 128, 64), [0, 2]),
    ("off the tiles", (3, 13, 200, 136), None),
]


@pytest.mark.parametrize("tag,shape,rows", MOE_WGMMA_CASES,
                         ids=[c[0] for c in MOE_WGMMA_CASES])
def test_moe_gemm_wgmma_route_matches_plain_and_skips_empty_experts(
        cuda, tag, shape, rows):
    e, c, d, f = shape
    if rows == "tick":
        rows = _tick_rows(cuda, e)
    buf, gate, up, down = _moe_case(cuda, e, c, d, f, rows)
    before, by_route = mops.launches, dict(mops.launches_by_route)
    got = mops.moe_mlp(buf, gate, up, down)
    assert mops.launches == before + 1
    assert _route_delta(mops, by_route) == {"wgmma": 1}
    _assert_kernel_close(got, moe_mlp_ref(buf, gate, up, down))
    _assert_empty_rows_are_positive_zero(buf, got)


def test_moe_gemm_counts_no_launch_at_zero_capacity(cuda):
    buf, gate, up, down = _moe_case(cuda, 4, 0, 64, 32)
    before, by_route = mops.launches, dict(mops.launches_by_route)
    got = mops.moe_mlp(buf, gate, up, down)
    assert got.shape == (4, 0, 64)
    assert mops.launches == before and mops.launches_by_route == by_route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_gemm_routes_off_the_tma_rule_and_fp32(cuda, dtype):
    """d % 8 != 0 takes the simple route in bf16; fp32 takes the fp32 route
    and skips its empty experts too; the forced simple route computes every
    expert and agrees."""
    buf, gate, up, down = _moe_case(cuda, 3, 5, 100, 36, dtype=dtype)
    by_route = dict(mops.launches_by_route)
    _assert_kernel_close(mops.moe_mlp(buf, gate, up, down),
                         moe_mlp_ref(buf, gate, up, down))
    want = "simple" if dtype == torch.bfloat16 else "fp32"
    assert _route_delta(mops, by_route) == {want: 1}
    buf, gate, up, down = _moe_case(cuda, 8, 3, 128, 64, [1, 6], dtype=dtype)
    got = mops.moe_mlp(buf, gate, up, down)
    _assert_kernel_close(got, moe_mlp_ref(buf, gate, up, down))
    _assert_empty_rows_are_positive_zero(buf, got)
    if dtype == torch.bfloat16:
        by_route = dict(mops.launches_by_route)
        simple = mops.moe_mlp_simple_bf16(buf, gate, up, down)
        assert _route_delta(mops, by_route) == {"simple": 1}
        _assert_kernel_close(simple, moe_mlp_ref(buf, gate, up, down))


def test_moe_gemm_wgmma_in_a_cuda_graph_follows_the_occupancy(cuda):
    """One recorded launch replayed on buffers whose set of nonempty experts
    changes between replays (as from tick to tick): each replay equals the
    plain version, and empty experts' rows are +0."""
    e, c, d, f = 64, 2, 256, 128
    buf, gate, up, down = _moe_case(cuda, e, c, d, f, _tick_rows(cuda, e, 4,
                                                                 4))
    static = buf.clone()
    mops.moe_mlp(static, gate, up, down)             # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mops.moe_mlp(static, gate, up, down)
    for seed, rows in ((1, [5]), (2, list(range(0, e, 3))), (3, []),
                       (4, list(range(e)))):
        new, _, _, _ = _moe_case(cuda, e, c, d, f, rows, seed=seed)
        static.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        _assert_kernel_close(out, moe_mlp_ref(static, gate, up, down))
        _assert_empty_rows_are_positive_zero(static, out)


# device counts (the expert-parallel layer's dropless buffers): a count of
# 0, counts inside the first row tile, across row chunks (C = 150 takes
# 64-row chunks), at C and past it (read as C); one expert holding nearly
# every row; more active experts than a warp scans at once; past the
# counted wgmma route's 1024 experts (the simple route); each route
MOE_COUNT_CASES = [
    ("wgmma", (6, 150, 256, 128), [0, 3, 64, 65, 150, 400],
     torch.bfloat16),
    ("wgmma", (8, 512, 512, 256), [16, 0, 31, 7, 1, 0, 24, 19],
     torch.bfloat16),
    ("wgmma", (3, 512, 256, 128), [500, 0, 130], torch.bfloat16),
    ("wgmma", (40, 70, 128, 64), [(7 * j) % 71 for j in range(40)],
     torch.bfloat16),
    ("simple", (1025, 2, 64, 32), [j % 3 for j in range(1025)],
     torch.bfloat16),
    ("simple", (4, 37, 100, 36), [0, 5, 37, 12], torch.bfloat16),
    ("fp32", (4, 37, 128, 64), [9, 0, 37, 1], torch.float32),
]


@pytest.mark.parametrize("route,shape,counts,dtype", MOE_COUNT_CASES,
                         ids=[f"{c[0]}-E{c[1][0]}-C{c[1][1]}"
                              for c in MOE_COUNT_CASES])
def test_moe_gemm_device_counts_compute_only_the_counted_rows(
        cuda, route, shape, counts, dtype):
    """With device counts each expert's first ``min(count, C)`` rows equal
    the plain version's and every other row of ``out`` keeps its value
    (NaN here, bit for bit), in every route."""
    e, c, d, f = shape
    buf, gate, up, down = _moe_case(cuda, e, c, d, f, dtype=dtype)
    cnt = torch.tensor(counts, dtype=torch.int32, device=cuda)
    out = torch.full_like(buf, float("nan"))
    by_route = dict(mops.launches_by_route)
    got = mops.moe_mlp(buf, gate, up, down, counts=cnt, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert _route_delta(mops, by_route) == {route: 1}
    want = moe_mlp_ref(buf, gate, up, down)
    kept = torch.arange(c, device=cuda)[None, :] < cnt.clamp(max=c)[:, None]
    _assert_kernel_close(got[kept], want[kept])
    assert bool(torch.isnan(got[~kept]).all())
    # the plain version's counted form keeps the same rows
    plain = moe_mlp_ref(buf, gate, up, down, cnt,
                        torch.full_like(buf, float("nan")))
    assert bool(torch.isnan(plain[~kept]).all())
    assert torch.equal(plain[kept], want[kept])


def test_moe_gemm_device_counts_in_a_cuda_graph(cuda):
    """One recorded launch replayed as the counts change on the card (as
    from forward to forward of the expert-parallel layer)."""
    e, c, d, f = 8, 512, 256, 128
    buf, gate, up, down = _moe_case(cuda, e, c, d, f)
    cnt = torch.zeros(e, dtype=torch.int32, device=cuda)
    out = torch.empty_like(buf)
    mops.moe_mlp(buf, gate, up, down, counts=cnt, out=out)     # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        mops.moe_mlp(buf, gate, up, down, counts=cnt, out=out)
    want = moe_mlp_ref(buf, gate, up, down)
    for counts in ([16, 0, 31, 7, 1, 0, 24, 19], [0] * e, [512] * e,
                   [70, 130, 0, 3, 500, 64, 65, 2]):
        cnt.copy_(torch.tensor(counts, dtype=torch.int32))
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        kept = torch.arange(c, device=cuda)[None, :] < cnt[:, None]
        _assert_kernel_close(out[kept], want[kept])
        assert bool(torch.isnan(out[~kept]).all())


@pytest.mark.parametrize("b,h,t,k", [(1, 32, 64, 64), (8, 32, 1, 64),
                                     (2, 3, 17, 64), (2, 2, 33, 16)])
def test_rwkv6_kernel_matches_plain(cuda, b, h, t, k):
    r, kk, v = (_randn(cuda, s, b, h, t, k) for s in (40, 41, 42))
    g = torch.Generator(device=cuda).manual_seed(43)
    w = 0.8 + 0.199 * torch.rand(b, h, t, k, generator=g, device=cuda)
    u = _randn(cuda, 44, h, k)
    s0 = _randn(cuda, 45, b, h, k, k)
    before = wops.launches
    out, s_final = wops.rwkv6(r, kk, v, w, u, s0)
    assert wops.launches == before + 1
    want_out, want_s = rwkv6_ref(r, kk, v, w, u, s0)
    _assert_kernel_close(out, want_out)
    _assert_kernel_close(s_final, want_s)


def _wkv_case(cuda, b, h, t, k, decays, seed=60):
    """r, k, v, u, s0 normal; w strong (uniform over (0, 1) with a sixth
    exact zeros and a sixth 1 - 1e-7) or near 1 (within 2e-3)."""
    r, kk, v = (_randn(cuda, seed + i, b, h, t, k) for i in range(3))
    g = torch.Generator(device=cuda).manual_seed(seed + 3)
    if decays == "strong":
        w = torch.rand(b, h, t, k, generator=g, device=cuda)
        pick = torch.rand(b, h, t, k, generator=g, device=cuda)
        w = torch.where(pick < 1 / 6, torch.zeros_like(w), w)
        w = torch.where(pick > 5 / 6, torch.full_like(w, 1 - 1e-7), w)
    else:
        w = 1 - 2e-3 * torch.rand(b, h, t, k, generator=g, device=cuda)
    return r, kk, v, w, _randn(cuda, seed + 4, h, k), _randn(
        cuda, seed + 5, b, h, k, k)


def _launch_rwkv6(route, r, k, v, w, u, s0):
    from repro_torch.kernels.rwkv6.kernel import rwkv6_cuda
    out = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    rwkv6_cuda(r, k, v, w, u, s0, out, s_final, route)
    return out, s_final


def _assert_finite_close(got, want):
    assert bool(torch.isfinite(got).all())
    _assert_kernel_close(got, want)


@pytest.mark.parametrize("decays", ["strong", "near one"])
@pytest.mark.parametrize("b,h,t,k", [(1, 32, 512, 64), (1, 32, 700, 64),
                                     (2, 3, 17, 64), (2, 2, 33, 16)])
def test_rwkv6_chunked_route_matches_plain(cuda, b, h, t, k, decays):
    """The chunked route (forced below CHUNKED_MIN_T) at 1e-5 of
    max|plain| on out and s_final, with exact-zero decays and decays near
    1: no NaN or inf."""
    args = _wkv_case(cuda, b, h, t, k, decays)
    out, s_final = _launch_rwkv6("chunked", *args)
    want_out, want_s = rwkv6_ref(*args)
    _assert_finite_close(out, want_out)
    _assert_finite_close(s_final, want_s)


def test_rwkv6_routes_by_t_and_agrees_with_the_step_route(cuda):
    args = _wkv_case(cuda, 1, 32, 512, 64, "strong")
    by_route = dict(wops.launches_by_route)
    out, s_final = wops.rwkv6(*args)
    step_out, step_s = wops.rwkv6_step(*args)
    assert _route_delta(wops, by_route) == {"chunked": 1, "step": 1}
    _assert_finite_close(out, step_out)
    _assert_finite_close(s_final, step_s)
    short = _wkv_case(cuda, 8, 32, 1, 64, "strong")
    by_route = dict(wops.launches_by_route)
    wops.rwkv6(*short)
    assert _route_delta(wops, by_route) == {"step": 1}


@pytest.mark.parametrize("t", [1, 700])
def test_rwkv6_model_reads_the_model_layout_in_place(cuda, t):
    """Strided [B,T,H,K] views (columns of one wider projection) give the
    kernel layout's result; y comes back contiguous."""
    b, h, k = 2, 4, 64
    wide = _randn(cuda, 70, b, t, 4, h, k + 8)
    views = [wide[:, :, i, :, :k] for i in range(4)]
    views[3] = torch.sigmoid(wide[:, :, 3, :, :k])
    u, s0 = _randn(cuda, 71, h, k), _randn(cuda, 72, b, h, k, k)
    by_route = dict(wops.launches_by_route)
    y, s_final = wops.rwkv6_model(*views, u, s0)
    assert _route_delta(wops, by_route) == {
        "chunked" if t >= wops.CHUNKED_MIN_T else "step": 1}
    assert y.shape == (b, t, h, k) and y.is_contiguous()
    want_y, want_s = rwkv6_ref(*[x.transpose(1, 2) for x in views], u, s0)
    _assert_finite_close(y, want_y.transpose(1, 2))
    _assert_finite_close(s_final, want_s)


def test_rwkv6_chunked_launch_in_a_cuda_graph_follows_new_inputs(cuda):
    """One chunked launch recorded into a CUDA graph (its scratch from the
    graph's pool), replayed after the inputs are overwritten in place."""
    static = list(_wkv_case(cuda, 1, 8, 200, 64, "strong"))
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        wops.rwkv6(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    by_route = dict(wops.launches_by_route)
    with torch.cuda.graph(graph):
        out, s_final = wops.rwkv6(*static)
    assert _route_delta(wops, by_route) == {"chunked": 1}
    for seed in (80, 90):
        for x, y in zip(static, _wkv_case(cuda, 1, 8, 200, 64, "near one",
                                          seed)):
            x.copy_(y)
        graph.replay()
        torch.cuda.synchronize()
        want_out, want_s = rwkv6_ref(*static)
        _assert_finite_close(out, want_out)
        _assert_finite_close(s_final, want_s)


def test_moe_and_rwkv_wrappers_raise_on_device_dtype_and_layout(cuda):
    buf = torch.zeros(2, 3, 64, device=cuda)
    w = torch.zeros(2, 64, 32, device=cuda)
    down = torch.zeros(2, 32, 64, device=cuda)
    with pytest.raises(ValueError, match="devices"):
        mops.moe_mlp(buf, w.cpu(), w, down)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        mops.moe_mlp(buf.half(), w.half(), w.half(), down.half())
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros(2, 3, 128, device=cuda)
        mops.moe_mlp(wide[..., ::2], w, w, down)
    x = torch.zeros(1, 2, 5, 64, device=cuda)
    u, s0 = torch.zeros(2, 64, device=cuda), torch.zeros(1, 2, 64, 64,
                                                         device=cuda)
    with pytest.raises(TypeError, match="fp32"):
        wops.rwkv6(x.bfloat16(), x, x, x, u, s0)
    with pytest.raises(ValueError, match="head sizes"):
        big = torch.zeros(1, 2, 5, 80, device=cuda)
        wops.rwkv6(big, big, big, big, torch.zeros(2, 80, device=cuda),
                   torch.zeros(1, 2, 80, 80, device=cuda))


def _family_engine(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import InferenceEngine
    model = Model(get_config(arch, smoke=True), use_kernels=True)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    return InferenceEngine(model, params, max_slots=4, max_len=64, seed=1)


@pytest.mark.parametrize("arch,kernel", [("kimi-k2-1t-a32b", "moe_gemm"),
                                         ("rwkv6-1.6b", "rwkv6")])
def test_family_decode_step_graph_is_bit_equal_to_the_eager_step(cuda, arch,
                                                                 kernel):
    """The decode step of a Kimi-K2 or RWKV6 smoke engine, recorded into a
    CUDA graph, gives the eager step's logits and caches bit for bit (the
    RWKV state is put back between the two, since each step advances it)."""
    from repro_torch.serving import Request
    from repro_torch.serving.engine import _leaves
    engine = _family_engine(cuda, arch)
    for i in range(3):
        engine.submit(Request(rid=i, prompt=[5 + i, 9, 2, 7], max_tokens=30))
    for _ in range(5):
        engine.step()
    assert engine.decode_graph.recorded_launches[kernel] > 0
    before = [t.clone() for t in _leaves(engine.caches)]
    graph_logits = engine._step([engine.last_token, engine.pos]).clone()
    after_graph = [t.clone() for t in _leaves(engine.caches)]
    for leaf, kept in zip(_leaves(engine.caches), before):
        leaf.copy_(kept)
    eager = engine._eager_decode()
    assert torch.equal(graph_logits, eager)
    for a, b in zip(after_graph, _leaves(engine.caches)):
        assert torch.equal(a, b)


# ---- mamba_scan (the op graph's Mamba scan stage) ------------------------------

from repro_torch.kernels.mamba_scan import ops as sops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import mamba_scan_stage_ref  # noqa: E402


def _scan_case(cuda, b, t, di, n, seed=100):
    """packed [B,T,2·di+2·N+1] fp32 (x, z, B, C normal; Δ_raw normal, with
    a few past softplus's threshold of 20), a general a_log (not log(1..N))
    and a nonzero d_skip."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    packed = torch.randn(b, t, 2 * di + 2 * n + 1, generator=g, device=cuda)
    packed[:, ::5, -1] += 22.0
    a_log = torch.rand(di, n, generator=g, device=cuda) * 4.0 - 1.5
    d_skip = torch.randn(di, generator=g, device=cuda)
    return packed, a_log, d_skip


def _assert_scan_close(got, want):
    """fp32 within 1e-5 of max|plain|; bf16 within 1e-2 relative L2 (the
    plain version rounds y and silu(z) to bf16 before their product, the
    kernel rounds once)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    if got.dtype == torch.bfloat16:
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        assert rel <= 1e-2, rel
    else:
        _assert_kernel_close(got, want)


# the cell's shape (Hymba-1.5B at 1 x 512), T in {1, 7, 33, 512}, B 2, di off
# the block's 8 channels, N off the lanes' 4 and the largest N
SCAN_CASES = [(1, 512, 3200, 16), (1, 1, 3200, 16), (2, 7, 24, 4),
              (2, 33, 100, 16), (2, 512, 52, 5), (1, 33, 44, 64)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,di,n", SCAN_CASES)
def test_mamba_scan_kernel_matches_plain(cuda, dtype, b, t, di, n):
    packed, a_log, d_skip = _scan_case(cuda, b, t, di, n)
    packed = packed.to(dtype)
    before = sops.launches
    out = sops.mamba_scan_stage(packed, a_log, d_skip)
    assert sops.launches == before + 1
    _assert_scan_close(out, mamba_scan_stage_ref(packed, a_log, d_skip))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba_scan_reads_strided_views_in_place(cuda, dtype):
    """packed as a window of a wider, longer tensor, and as the batch
    transpose of a [T, B, W] tensor: the kernel reads both through their
    strides and gives the contiguous copy's result."""
    b, t, di, n = 2, 33, 100, 16
    w = 2 * di + 2 * n + 1
    packed, a_log, d_skip = _scan_case(cuda, b, t, di, n)
    packed = packed.to(dtype)
    wide = torch.zeros(b, t + 3, w + 11, dtype=dtype, device=cuda)
    wide[:, 2:t + 2, 5:w + 5] = packed
    window = wide[:, 2:t + 2, 5:w + 5]
    swapped = packed.transpose(0, 1).contiguous().transpose(0, 1)
    want = sops.mamba_scan_stage(packed, a_log, d_skip)
    for view in (window, swapped):
        assert not view.is_contiguous()
        got = sops.mamba_scan_stage(view, a_log, d_skip)
        assert torch.equal(got, want)
    _assert_scan_close(want, mamba_scan_stage_ref(packed, a_log, d_skip))


def test_mamba_scan_launch_in_a_cuda_graph_follows_new_inputs(cuda):
    static = list(_scan_case(cuda, 1, 200, 3200, 16))
    static[0] = static[0].bfloat16()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sops.mamba_scan_stage(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = sops.launches
    with torch.cuda.graph(graph):
        out = sops.mamba_scan_stage(*static)
    assert sops.launches == before + 1
    for seed in (110, 120):
        fresh = _scan_case(cuda, 1, 200, 3200, 16, seed)
        for x, y in zip(static, fresh):
            x.copy_(y)
        graph.replay()
        torch.cuda.synchronize()
        _assert_scan_close(out, mamba_scan_stage_ref(*static))


def test_hymba_op_graph_lanes_are_bit_equal_to_one_stream_and_eager(cuda):
    """The Hymba smoke op graph (bf16) recorded on its lanes launches the
    scan kernel once a layer and gives the one-stream recording's and the
    eager walk's logits bit for bit, request after request."""
    from repro_torch.configs import get_config
    from repro_torch.models.opgraph_export import build_lm_opgraph
    from repro_torch.models.transformer import init_lm
    cfg = get_config("hymba-1.5b", smoke=True)
    params = init_lm(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    g = build_lm_opgraph(cfg, batch=2, seq=12, params=params)
    exe = compile_plan(schedule(g, "opara", "opara"))
    assert exe.lane_stats()["n_lanes"] > 1
    gen = torch.Generator(device=cuda).manual_seed(1)
    requests = [{"tokens": torch.randint(0, cfg.vocab_size, (2, 12),
                                         generator=gen, device=cuda)}
                for _ in range(2)]
    outs = [exe(r) for r in requests]          # record, then replay
    assert exe.replay.recorded_launches["mamba_scan"] == cfg.n_layers
    one = CudaGraphReplay(exe.fn, [requests[0]["tokens"]])
    for got, inputs in zip(outs, requests):
        single = one([inputs["tokens"]])
        eager = exe.call_uncompiled(inputs)
        assert all(torch.equal(a, b) for a, b in zip(got, single))
        assert all(torch.equal(a, b) for a, b in zip(got, eager))
    assert not all(torch.equal(a, b) for a, b in zip(*outs))


def _rel_l2_err(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("kvh,g,dk,dv", [(2, 16, 128, 128), (5, 5, 64, 64),
                                         (1, 32, 576, 512)],
                         ids=["glm4", "hymba", "mla"])
def test_attention_products_on_tensor_cores_match_the_fp32_einsum(
        cuda, kvh, g, dk, dv):
    """bf16 operands at 1 x 512: the payloads' tensor-core products (V a
    strided slice of K for MLA) against the fp32 einsum over the same
    values: logits to fp32 summation order, the context to one bf16 ulp."""
    from repro_torch.models import opgraph_export as ox
    gen = torch.Generator(device=cuda).manual_seed(4)
    s, bf16 = 512, torch.bfloat16
    q = torch.randn(1, s, kvh * g, dk, generator=gen, device=cuda).to(
        bf16).permute(0, 2, 1, 3)
    if dk != dv:
        k = torch.randn(1, 1, s, dk, generator=gen, device=cuda).to(bf16)
        v = k[..., :dv]
    else:
        k, v = (torch.randn(1, s, kvh, d, generator=gen, device=cuda).to(
            bf16).permute(0, 2, 1, 3) for d in (dk, dv))
    before = ox.attn_tc_products
    scores = ox._scores_payload(q, k)
    p = torch.softmax(scores * dk ** -0.5, -1)
    ctx = ox._ctx_payload(p, v)
    assert ox.attn_tc_products == before + 2
    want = ox._scores_payload(q.float(), k.float())
    assert scores.dtype == torch.float32 and _rel_l2_err(scores, want) < 1e-5
    pg = p.reshape(1, kvh, g, s, s).to(bf16).float()
    ctx32 = torch.einsum("bkgst,bktd->bkgsd", pg, v.float())
    assert ctx.dtype == bf16
    assert _rel_l2_err(ctx, ctx32.reshape(ctx.shape)) < 4e-3


@pytest.mark.parametrize("arch", ["glm4-9b", "deepseek-v3-671b"])
def test_op_graph_counts_its_attention_products_on_tensor_cores(cuda, arch):
    """A bf16 smoke op graph records two tensor-core attention products a
    layer, and its lanes give the one-stream recording's logits bit for
    bit."""
    from repro_torch.configs import get_config
    from repro_torch.models.opgraph_export import build_lm_opgraph
    from repro_torch.models.transformer import init_lm
    cfg = get_config(arch, smoke=True)
    params = init_lm(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    g = build_lm_opgraph(cfg, batch=2, seq=12, params=params)
    exe = compile_plan(schedule(g, "opara", "opara"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    got = exe({"tokens": tokens})
    assert exe.replay.recorded_launches["attn_tc_products"] == 2 * cfg.n_layers
    one = CudaGraphReplay(exe.fn, [tokens])
    assert all(torch.equal(a, b) for a, b in zip(got, one([tokens])))


def test_kernel_dag_reads_a_one_kernel_graph(cuda):
    """A scan stage recorded alone is one kernel node with no edge (the
    Hymba phase of chip_smoke.py records it so)."""
    static = list(_scan_case(cuda, 1, 33, 100, 16))
    rep = CudaGraphReplay(lambda p: [sops.mamba_scan_stage(p, *static[1:])],
                          [static[0]])
    assert rep.kernel_dag() == (1, 1)


def test_mamba_scan_wrapper_raises_on_device_dtype_shape_and_strides(cuda):
    packed, a_log, d_skip = _scan_case(cuda, 1, 5, 24, 4)
    with pytest.raises(ValueError, match="devices"):
        sops.mamba_scan_stage(packed, a_log.cpu(), d_skip)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        sops.mamba_scan_stage(packed.half(), a_log, d_skip)
    with pytest.raises(TypeError, match="fp32 a_log"):
        sops.mamba_scan_stage(packed, a_log.bfloat16(), d_skip)
    with pytest.raises(ValueError, match="2·di"):
        sops.mamba_scan_stage(packed[..., :-1], a_log, d_skip)
    with pytest.raises(ValueError, match="packed"):
        sops.mamba_scan_stage(packed[0], a_log, d_skip)
    with pytest.raises(ValueError, match="last dim contiguous"):
        wide = torch.zeros(1, 5, 2 * packed.shape[-1], device=cuda)
        sops.mamba_scan_stage(wide[..., ::2], a_log, d_skip)
    with pytest.raises(ValueError, match="contiguous a_log"):
        sops.mamba_scan_stage(packed, a_log.t().contiguous().t(), d_skip)
    with pytest.raises(ValueError, match="states"):
        big = torch.zeros(1, 5, 2 * 24 + 2 * 80 + 1, device=cuda)
        sops.mamba_scan_stage(big, torch.zeros(24, 80, device=cuda), d_skip)


# ---- the MLA form of paged decode ---------------------------------------------

from repro_torch.kernels.paged_decode.ref import (  # noqa: E402
    paged_mla_decode_attention_ref)

# (B, H, D_nope, rank, rope, ps, MAXP): small, off every multiple (20 heads,
# rank 40, rope 12 → the scalar load path), and DeepSeek-V3's serving shape
# (128 heads, rank 512, rope 64) at 4-, 16- and 128-position pages
MLA_CASES = [(3, 4, 16, 16, 8, 4, 7), (2, 20, 24, 40, 12, 16, 5),
             (8, 128, 128, 512, 64, 16, 64), (2, 128, 128, 512, 64, 4, 40),
             (2, 128, 128, 512, 64, 128, 3)]


def _mla_case(cuda, dtype, b, h, nope, rank, rope, ps, maxp):
    """A shuffled table with trailing null pages on the last row; ragged
    lengths from every position of the table down to one."""
    n_pages = 1 + b * maxp
    q_nope = _randn(cuda, 50, b, h, nope, dtype=dtype)
    q_pe = _randn(cuda, 51, b, h, rope, dtype=dtype)
    ckv = _randn(cuda, 52, n_pages, ps, rank, dtype=dtype)
    kpe = _randn(cuda, 53, n_pages, ps, rope, dtype=dtype)
    wk_b = _randn(cuda, 54, rank, h, nope, dtype=dtype, scale=nope ** -0.5)
    g = torch.Generator().manual_seed(55)
    bt = (torch.randperm(n_pages - 1, generator=g) + 1).reshape(
        b, maxp).to(torch.int32)
    bt[-1, maxp // 2:] = 0
    lengths = torch.linspace(maxp * ps, 1, b).round().to(torch.int32)
    lengths[-1] = min(int(lengths[-1]), (maxp // 2) * ps)
    return (q_nope, q_pe, ckv, kpe, wk_b, bt.to(cuda), lengths.to(cuda),
            (nope + rope) ** -0.5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,nope,rank,rope,ps,maxp", MLA_CASES)
def test_paged_mla_kernel_matches_plain(cuda, dtype, b, h, nope, rank, rope,
                                        ps, maxp):
    args = _mla_case(cuda, dtype, b, h, nope, rank, rope, ps, maxp)
    before = pops.mla_launches
    got = pops.paged_mla_decode_attention(*args)
    assert pops.mla_launches == before + 1
    assert got.shape == (b, h, rank) and got.dtype == dtype
    _assert_kernel_close(got, paged_mla_decode_attention_ref(*args))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_mla_kernel_averages_v_on_a_row_with_no_attended_position(
        cuda, dtype):
    args = list(_mla_case(cuda, dtype, 3, 128, 128, 512, 64, 16, 6))
    args[6] = torch.tensor([0, 50, 0], dtype=torch.int32, device=cuda)
    got = pops.paged_mla_decode_attention(*args)
    _assert_kernel_close(got, paged_mla_decode_attention_ref(*args))
    ckv, bt = args[2], args[5]
    mean = ckv[bt[0].long()].float().reshape(-1, 512).mean(0)
    torch.testing.assert_close(got[0].float(), mean.expand(128, 512),
                               rtol=1e-2, atol=1e-2)


def test_paged_mla_wrapper_raises_on_device_dtype_and_width(cuda):
    args = list(_mla_case(cuda, torch.float32, 2, 4, 16, 16, 8, 4, 3))
    with pytest.raises(ValueError, match="devices"):
        pops.paged_mla_decode_attention(*args[:5], args[5].cpu(), *args[6:])
    with pytest.raises(TypeError, match="bf16 or fp32"):
        pops.paged_mla_decode_attention(*[a.half() for a in args[:5]],
                                        *args[5:])
    with pytest.raises(ValueError, match="int32"):
        pops.paged_mla_decode_attention(*args[:5], args[5].long(), *args[6:])
    wide = list(_mla_case(cuda, torch.float32, 2, 4, 16, 520, 8, 4, 3))
    with pytest.raises(ValueError, match="latent rank"):
        pops.paged_mla_decode_attention(*wide)


def _mla_serving_case(cuda, ps, lengths, seed=0):
    """DeepSeek-V3's widths (128 heads, rank 512, rope 64, nope 128) at 8
    slots of 1024 positions through a shuffled table of ``ps``-position
    pages (page 0 the null page)."""
    b, h, nope, rank, rope = 8, 128, 128, 512, 64
    maxp = 1024 // ps
    n_pages = 1 + b * maxp
    dt = torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    bt = (torch.randperm(n_pages - 1, generator=g) + 1).reshape(
        b, maxp).to(torch.int32)
    return [_randn(cuda, seed + 1, b, h, nope, dtype=dt),
            _randn(cuda, seed + 2, b, h, rope, dtype=dt),
            _randn(cuda, seed + 3, n_pages, ps, rank, dtype=dt),
            _randn(cuda, seed + 4, n_pages, ps, rope, dtype=dt),
            _randn(cuda, seed + 5, rank, h, nope, dtype=dt,
                   scale=nope ** -0.5),
            bt.to(cuda), torch.tensor(lengths, dtype=torch.int32,
                                      device=cuda),
            (nope + rope) ** -0.5]


MLA_LENGTHS = {"full": [1024] * 8,
               "ragged": [17, 1024, 300, 64, 65, 999, 128, 512],
               "all-masked rows": [0, 300, 0, 1024, 5, 0, 64, 1]}


@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("lengths", sorted(MLA_LENGTHS))
def test_paged_mla_wgmma_route_matches_plain_and_the_simple_route(cuda, ps,
                                                                  lengths):
    args = _mla_serving_case(cuda, ps, MLA_LENGTHS[lengths])
    assert pops.mla_route(*args[1:4]) == "wgmma"
    by_route = dict(pops.mla_launches_by_route)
    got = pops.paged_mla_decode_attention(*args)
    simple = pops.paged_mla_decode_simple_bf16(*args)
    assert {k: v - by_route[k] for k, v in pops.mla_launches_by_route.items()
            if v != by_route[k]} == {"wgmma": 1, "simple": 1}
    want = paged_mla_decode_attention_ref(*args)
    assert bool(torch.isfinite(got.float()).all())
    _assert_kernel_close(got, want)
    _assert_kernel_close(got, simple)


@pytest.mark.parametrize("ps", [16, 128])
def test_paged_mla_wgmma_never_reads_table_entries_past_a_length(cuda, ps):
    """Entries past each row's length point at a page of inf: the wgmma
    route gives the plain version's result on a clean table."""
    lengths = MLA_LENGTHS["ragged"]
    args = _mla_serving_case(cuda, ps, lengths, seed=10)
    pages = args[2].shape[0]
    args[2] = torch.cat([args[2], torch.full_like(args[2][:1], float("inf"))])
    args[3] = torch.cat([args[3], torch.full_like(args[3][:1], float("inf"))])
    clean = args[5].clone()
    for row, n in enumerate(lengths):
        args[5][row, -(-n // ps):] = pages
    got = pops.paged_mla_decode_attention(*args)
    assert bool(torch.isfinite(got.float()).all())
    _assert_kernel_close(got, paged_mla_decode_attention_ref(
        *args[:5], clean, *args[6:]))


def test_paged_mla_route_rule_on_the_card(cuda):
    """wgmma at rank 512 / rope 64 with 8-, 16-, 32- or 64k-position pages
    and 16-byte strides; simple for other bf16 shapes; fp32 for fp32."""
    args = _mla_serving_case(cuda, 16, MLA_LENGTHS["full"])
    q_pe, ckv, kpe = args[1:4]
    assert pops.mla_route(q_pe, ckv, kpe) == "wgmma"
    assert pops.mla_route(q_pe.float(), ckv.float(), kpe.float()) == "fp32"
    odd = _randn(cuda, 1, 9, 4, 512, dtype=torch.bfloat16)
    assert pops.mla_route(q_pe, odd, odd[..., :64]) == "simple"
    assert pops.mla_route(q_pe, ckv[..., :256], kpe) == "simple"


def test_deepseek_paged_decode_step_graph_is_bit_equal_to_the_eager_step(
        cuda):
    """The paged decode step of a DeepSeek-V3 smoke engine, recorded into a
    CUDA graph with the MLA kernel, gives the eager step's logits and latent
    pages bit for bit; in fp32 (rounding far below the greedy margins) its
    streams equal the dense engine's, whose latent attention is plain."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import InferenceEngine, Request
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", smoke=True),
                              dtype=torch.float32)
    model = Model(cfg, use_kernels=True)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    outputs = {}
    for paged in (False, True):
        engine = InferenceEngine(model, params, max_slots=4, max_len=64,
                                 seed=1, paged_kv=paged, page_size=4)
        reqs = [Request(rid=i, prompt=[5 + i, 9, 2, 7, 3][:3 + i],
                        max_tokens=12) for i in range(3)]
        for r in reqs:
            engine.submit(r)
        for _ in range(5):
            engine.step()
        if paged:
            assert engine.decode_graph.recorded_launches[
                "paged_decode_mla"] > 0
            values = [engine.last_token, engine.pos,
                      engine._block_table_array()]
            graph_logits = engine._step(values).clone()
            pages = [t.clone() for kv in engine.caches for t in kv]
            eager = engine.model.paged_decode(
                engine.params, engine._on_device(engine.last_token,
                                                 torch.long),
                engine.caches, engine._on_device(values[2], torch.int32),
                engine._on_device(engine.pos, torch.int32))[0]
            assert torch.equal(graph_logits, eager)
            for a, kv in zip(pages, (t for kv in engine.caches for t in kv)):
                assert torch.equal(a, kv)
        engine.run(200)
        outputs[paged] = [tuple(r.output) for r in reqs]
    assert outputs[True] == outputs[False]


# ---- the encoder-decoder facade (Whisper) -----------------------------------------------

def _whisper_case(cuda, dtype, batch=3, prompt=4, cache_len=32):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("whisper-medium", smoke=True),
                              dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(22)
    params = Model(cfg).init(g, cuda)
    fe = cfg.frontend
    inputs = {"frames": torch.randn(batch, fe.n_tokens, fe.feat_dim,
                                    generator=g, device=cuda).to(dtype),
              "tokens": torch.randint(1, cfg.vocab_size, (batch, prompt),
                                      generator=g, device=cuda)}
    return cfg, params, inputs, cache_len


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_whisper_kernel_route_matches_the_plain_route(cuda, dtype):
    """The smoke Whisper facade: prefill (the decoder's causal
    self-attention through flash_attention) and 6 decode ticks (its
    self-attention through decode_attention) on the kernel route against
    the plain route, both fed the plain route's greedy tokens: fp32 the
    same greedy tokens and logits within 1e-5 of max|plain|, bf16 relative
    L2 <= 2e-2.  Prints the step at which the two routes' greedy choices
    first differ, where free-running greedy streams would part."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import Model
    cfg, params, inputs, cache_len = _whisper_case(cuda, dtype)
    flash0, dec0 = fops.launches, dops.launches
    kernel, plain = Model(cfg, use_kernels=True), Model(cfg, use_kernels=False)
    got, k_caches = kernel.prefill(params, inputs, cache_len=cache_len)
    want, p_caches = plain.prefill(params, inputs, cache_len=cache_len)
    pairs = [(got, want)]
    for i in range(6):
        tok = want.argmax(-1)
        pos = torch.full((tok.shape[0],), inputs["tokens"].shape[1] + i,
                         dtype=torch.int32, device=cuda)
        got, k_caches = kernel.decode(params, tok, k_caches, pos)
        want, p_caches = plain.decode(params, tok, p_caches, pos)
        pairs.append((got, want))
    assert fops.launches - flash0 == cfg.n_dec_layers
    assert dops.launches - dec0 == 6 * cfg.n_dec_layers
    # before this step the two routes' free-running greedy streams agree
    parted = next((i for i, (got, want) in enumerate(pairs)
                   if not torch.equal(got.argmax(-1), want.argmax(-1))), None)
    print(f"whisper smoke {dtype}: per-step rel_l2 "
          f"{[round(_rel_l2(*p), 6) for p in pairs]}; the kernel route's "
          f"greedy choice first differs at step {parted} (0 = prefill)")
    for got, want in pairs:
        assert bool(torch.isfinite(got).all())
        if dtype == torch.float32:
            assert torch.equal(got.argmax(-1), want.argmax(-1))
            _assert_kernel_close(got, want)
        else:
            assert _rel_l2(got, want) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_whisper_decode_step_graph_is_bit_equal_to_the_eager_step(cuda,
                                                                  dtype):
    """The smoke Whisper decode step recorded into a CUDA graph (token and
    position as its inputs, the caches written in place) gives the eager
    step's logits and self K/V bit for bit, at two positions."""
    from repro_torch.models import Model
    cfg, params, inputs, cache_len = _whisper_case(cuda, dtype)
    model = Model(cfg, use_kernels=True)
    logits, caches = model.prefill(params, inputs, cache_len=cache_len)
    tok = logits.argmax(-1)
    b = tok.shape[0]

    def step(token, pos):
        return [model.decode(params, token, caches, pos)[0]]

    pos = torch.full((b,), 4, dtype=torch.int32, device=cuda)
    replay = CudaGraphReplay(step, [tok, pos])
    for p in (4, 5):
        pos = torch.full((b,), p, dtype=torch.int32, device=cuda)
        graph_logits = replay([tok, pos])[0]
        k_graph = caches[0][0][:, :, p].clone()
        eager = model.decode(params, tok, caches, pos)[0]
        assert torch.equal(graph_logits, eager)
        assert torch.equal(k_graph, caches[0][0][:, :, p])
        tok = eager.argmax(-1)


# ---- chunked_attention and the vision-language facade (llava) -----------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h, kvh, dk, dv", [(32, 8, 128, 128),
                                            (16, 1, 576, 512)],
                         ids=["gqa", "mla"])
def test_chunked_attention_matches_sdpa_on_the_card(cuda, h, kvh, dk, dv,
                                                    dtype):
    """The plain route's long-prompt attention against ``_sdpa`` (the
    [S, T] route) on the same inputs, causal over 300 positions in chunks
    of 64 (padding, several KV chunks): fp32 within 1e-5 of max|_sdpa|;
    bf16 relative L2 <= 2e-2 (the probabilities are rounded unnormalised,
    ROADMAP C8)."""
    from repro_torch.models.attention import (_sdpa, causal_window_mask,
                                              chunked_attention)
    g = torch.Generator(device=cuda).manual_seed(h)
    s = 300
    q = torch.randn(2, s, h, dk, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, s, kvh, dk, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, s, kvh, dv, generator=g, device=cuda).to(dtype)
    i = torch.arange(s, device=cuda)
    for window in (None, 100):
        got = chunked_attention(q, k, v, causal=True, window=window,
                                q_chunk=64, kv_chunk=64)
        want = _sdpa(q, k, v, causal_window_mask(i, i, window))
        assert bool(torch.isfinite(got).all())
        if dtype == torch.float32:
            _assert_kernel_close(got, want)
        else:
            assert _rel_l2(got, want) <= 2e-2


def _llava_case(cuda, dtype, patches, prompt, batch=2):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("llava-next-mistral-7b", smoke=True),
                              dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(23)
    params = Model(cfg).init(g, cuda)
    inputs = {"extra_embeds": torch.randn(
                  batch, patches, cfg.frontend.feat_dim, generator=g,
                  device=cuda).to(dtype),
              "tokens": torch.randint(1, cfg.vocab_size, (batch, prompt),
                                      generator=g, device=cuda)}
    return cfg, params, inputs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("patches, prompt", [(8, 7), (2040, 64)],
                         ids=["short", "past-2048"])
def test_llava_smoke_prefill_kernel_route_matches_the_plain_route(
        cuda, dtype, patches, prompt):
    """The smoke llava facade's prefill with patch embeddings: the kernel
    route (flash on every layer) against the plain route (``_sdpa``, or
    past 2048 positions ``chunked_attention``), last-token logits and K/V;
    fp32 within 1e-5 of max|plain|, bf16 relative L2 <= 2e-2; then one
    decode tick each from its own caches."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import Model
    cfg, params, inputs = _llava_case(cuda, dtype, patches, prompt)
    s = patches + prompt
    kernel, plain = Model(cfg, use_kernels=True), Model(cfg, use_kernels=False)
    flash0 = fops.launches
    got, k_caches = kernel.prefill(params, inputs, cache_len=s + 4)
    assert fops.launches - flash0 == cfg.n_layers
    want, p_caches = plain.prefill(params, inputs, cache_len=s + 4)
    pairs = [(got, want)] + list(zip(k_caches[0], p_caches[0]))
    tok = want.argmax(-1)
    pos = torch.full((tok.shape[0],), s, dtype=torch.int32, device=cuda)
    pairs.append((kernel.decode(params, tok, k_caches, pos)[0],
                  plain.decode(params, tok, p_caches, pos)[0]))
    for got, want in pairs:
        assert bool(torch.isfinite(got).all())
        if dtype == torch.float32:
            _assert_kernel_close(got, want)
        else:
            assert _rel_l2(got, want) <= 2e-2


# ---- training: the chunked backward and one train step, card against CPU ------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h, kvh, dk, dv", [(14, 2, 64, 64),
                                            (16, 1, 576, 512)],
                         ids=["gqa", "mla"])
def test_chunked_attention_backward_matches_sdpa_autograd_on_the_card(
        cuda, h, kvh, dk, dv, dtype):
    """``chunked_attention``'s flash backward against the autograd of
    ``_sdpa`` on the same inputs and output grads, causal over 300
    positions in chunks of 128 (the last one short), with and without a
    window: fp32 dq, dk, dv within 1e-4 of max|_sdpa's|; bf16 relative L2
    <= 2e-2."""
    from repro_torch.models.attention import (_sdpa, causal_window_mask,
                                              chunked_attention)
    g = torch.Generator(device=cuda).manual_seed(h + 1)
    s = 300
    q = torch.randn(2, s, h, dk, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, s, kvh, dk, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, s, kvh, dv, generator=g, device=cuda).to(dtype)
    dout = torch.randn(2, s, h, dv, generator=g, device=cuda).to(dtype)
    i = torch.arange(s, device=cuda)
    for window in (None, 100):
        grads = []
        for chunked in (True, False):
            tq, tk, tv = (a.clone().requires_grad_(True) for a in (q, k, v))
            out = (chunked_attention(tq, tk, tv, causal=True, window=window,
                                     q_chunk=128, kv_chunk=128) if chunked
                   else _sdpa(tq, tk, tv, causal_window_mask(i, i, window)))
            grads.append(torch.autograd.grad(out, (tq, tk, tv), dout))
        for got, want in zip(*grads):
            assert bool(torch.isfinite(got).all())
            if dtype == torch.float32:
                err = (got - want).abs().max().item()
                assert err <= 1e-4 * want.abs().max().item()
            else:
                assert _rel_l2(got, want) <= 2e-2


def test_one_fp32_train_step_on_the_card_matches_the_cpu(cuda):
    """One ``make_train_step`` step of the fp32 smoke Qwen2 from the same
    params and batch on the card and on the CPU: loss within 1e-5
    relative, each grad leaf within 1e-4 relative L2, the new params (all
    leaves as one vector) within 1e-5 relative L2 (TF32 off: the same fp32
    math in another order; a leaf that starts at zero, the q/k/v biases,
    holds only AdamW's first update, sensitive to grads near eps)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data import make_dataset
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    from repro_torch.utils.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              dtype=torch.float32)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in
             make_dataset(cfg.vocab_size, 32, 4).batch_at(0).items()}
    runs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, _, grads = loss_and_grads(model, p, b)
        step = make_train_step(model, ParallelConfig(remat="none"),
                               base_lr=1e-3, warmup=0, total_steps=10)
        new, _, _ = step(p, adamw_init(p), b, 0)
        runs[str(dev)] = (float(loss), [t.cpu() for t in tree_leaves(grads)],
                          [t.cpu() for t in tree_leaves(new)])
    (l_cpu, g_cpu, p_cpu), (l_gpu, g_gpu, p_gpu) = runs.values()
    assert l_gpu == pytest.approx(l_cpu, rel=1e-5)
    for got, want in zip(g_gpu, g_cpu):
        assert _rel_l2(got, want) <= 1e-4
    assert _rel_l2(torch.cat([t.reshape(-1) for t in p_gpu]),
                   torch.cat([t.reshape(-1) for t in p_cpu])) <= 1e-5


# ---- the REPRO_* performance flags on the card ------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_slice_decode_graph_tick_is_bit_equal_to_eager(cuda, dtype,
                                                              monkeypatch):
    """Smoke Hymba under ``REPRO_WINDOW_SLICE_DECODE=1`` on the kernel
    route (the sliced layers run plain ``_sdpa``): the decode step
    recorded into a CUDA graph after the flag was set gives the eager
    step's logits and K/V bit for bit, at positions below and past the
    window."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    monkeypatch.setenv("REPRO_WINDOW_SLICE_DECODE", "1")
    cfg = dataclasses.replace(get_config("hymba-1.5b", smoke=True),
                              dtype=dtype)
    model = Model(cfg, use_kernels=True)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    cache_len = 40 + cfg.meta_tokens
    tokens = torch.randint(1, cfg.vocab_size, (2, 3), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    logits, caches = model.prefill(params, {"tokens": tokens},
                                   cache_len=cache_len)
    tok = logits.argmax(-1)
    kv = caches[0]["kv"][0]

    def step(token, pos):
        return [model.decode(params, token, caches, pos)[0]]

    pos = torch.full((2,), 3, dtype=torch.int32, device=cuda)
    saved = [t.clone() for t in (caches[0]["mamba_conv"],
                                 caches[0]["mamba_h"])]
    replay = CudaGraphReplay(step, [tok, pos])
    for p in (3, 4, 20):
        pos = torch.full((2,), p, dtype=torch.int32, device=cuda)
        # the Mamba state advances with every step: put it back between
        # the graph's tick and the eager one
        for leaf, kept in zip((caches[0]["mamba_conv"],
                               caches[0]["mamba_h"]), saved):
            leaf.copy_(kept)
        graph_logits = replay([tok, pos])[0].clone()
        k_graph = kv[:, :, p + cfg.meta_tokens].clone()
        for leaf, kept in zip((caches[0]["mamba_conv"],
                               caches[0]["mamba_h"]), saved):
            leaf.copy_(kept)
        eager = model.decode(params, tok, caches, pos)[0]
        assert torch.equal(graph_logits, eager)
        assert torch.equal(k_graph, kv[:, :, p + cfg.meta_tokens])
        saved = [t.clone() for t in (caches[0]["mamba_conv"],
                                     caches[0]["mamba_h"])]
        tok = eager.argmax(-1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [None, 300])
def test_causal_skip_is_bit_equal_on_the_card(cuda, dtype, window,
                                              monkeypatch):
    """``chunked_attention`` at S = T = 2304 (chunks of 2048, the last
    short) with ``REPRO_CAUSAL_SKIP`` on and off: bit-equal, forward and
    grads (the backward does not skip)."""
    from repro_torch.models.attention import chunked_attention
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, dout = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                     for shape in ((1, 2304, 8, 64), (1, 2304, 2, 64),
                                   (1, 2304, 2, 64), (1, 2304, 8, 64)))
    runs = []
    for value in ("0", "1"):
        monkeypatch.setenv("REPRO_CAUSAL_SKIP", value)
        tq, tk, tv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = chunked_attention(tq, tk, tv, causal=True, window=window)
        runs.append((out.detach(),
                     *torch.autograd.grad(out, (tq, tk, tv), dout)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_sharded_step_on_a_one_rank_nccl_mesh_matches_plain(cuda):
    """The fp32 smoke Qwen2's loss and grads with params and batch as
    ``DTensor``s on a 1-rank NCCL mesh (``param_shardings``,
    ``batch_specs``, the step under ``activation_rules``) against the plain
    step on the same params and batch: loss within 1e-5 relative, each
    grad leaf within 1e-4 relative L2."""
    import dataclasses
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import make_dataset
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import Model
    from repro_torch.parallel.sharding import (activation_rules, batch_specs,
                                               param_shardings, place,
                                               place_tree)
    from repro_torch.utils import logical_axis_rules
    from repro_torch.utils.tree import tree_leaves
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              dtype=torch.float32)
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    batch = {k: torch.from_numpy(v).to(cuda, torch.long) for k, v in
             make_dataset(cfg.vocab_size, 32, 4).batch_at(0).items()}
    loss, _, grads = loss_and_grads(model, params, batch)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_debug_mesh(1, 1)
        cell = ShapeCell("mesh", 32, 4, "train")
        params_s = place_tree(params, param_shardings(mesh, params), mesh)
        sp = batch_specs(mesh, cfg, batch, cell)
        batch_s = {k: place(v, mesh, sp[k]) for k, v in batch.items()}
        with logical_axis_rules(activation_rules(mesh, cell), mesh), \
                implicit_replication():
            loss_s, _, grads_s = loss_and_grads(model, params_s, batch_s)
        loss_s = loss_s.full_tensor()
        grads_s = [g.full_tensor() for g in tree_leaves(grads_s)]
    finally:
        dist.destroy_process_group()
    assert abs(float(loss_s) - float(loss)) <= 1e-5 * abs(float(loss))
    for got, want in zip(grads_s, tree_leaves(grads)):
        assert _rel_l2(got, want) <= 1e-4


# -- fault sites on the card (scripts/torch_chaos_smoke.py) --------------------

@pytest.mark.parametrize("index,kernels", [
    (0, ("branch_gemm",)),                     # kernel_compile, branchy graph
    (7, ("rmsnorm", "flash_attention", "decode_attention")),   # decode_step
], ids=["kernel_compile", "decode_step"])
def test_chaos_site_on_the_card(cuda, tmp_path, index, kernels):
    """One graph site and one engine site at smoke size on the card:
    ``kernel_compile`` raises out of lowering with no CUDA graph opened,
    then the disarmed build records the branch_gemm route and a replay made
    to fail at call time raises; ``decode_step`` corrupt fails one request
    and its raise mode latches the eager step, whose probation re-arms the
    recorded decode graph with every stream equal to the fault-free run."""
    from test_torch_chaos_smoke import chaos
    setup = chaos.Setup("cuda", "smoke", calib_dir=str(tmp_path))
    spec, check, _ = chaos.SCENARIOS[index]
    before = chaos.launch_counts()
    check(setup, spec)
    torch.cuda.synchronize()
    assert not torch.cuda.is_current_stream_capturing()
    launched = chaos.launches_since(before)
    assert all(launched.get(k) for k in kernels), launched
