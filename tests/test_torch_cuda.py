"""The port's kernels and CUDA-graph executor on the card.

Every test here needs a Hopper CUDA card and skips without one.  The file
imports neither JAX nor the JAX package, so it runs on a machine with only
PyTorch (the repository's conftest imports JAX; skip it there):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel vs plain bf16 1e-2 (both accumulate in fp32 and round
once to bf16: about one bf16 ulp apart at most); fp32 1e-5 of max|plain|
with TF32 off (summation order only); CUDA-graph replay vs per-op fp32
execution 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.capture import run_sequential_uncompiled  # noqa: E402
from repro_torch.core.graph import OpGraph, OpKind  # noqa: E402
from repro_torch.core.profiler import elementwise_cost, gemm_cost  # noqa: E402
from repro_torch.core.scheduler import compile_plan, schedule  # noqa: E402
from repro_torch.kernels.branch_gemm import ops as bops  # noqa: E402
from repro_torch.kernels.branch_gemm.ref import branch_gemm_ref  # noqa: E402
from repro_torch.kernels.grouped_gemm import ops as gops  # noqa: E402
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,m,k,f", [(2, 512, 896, 4864), (2, 512, 896, 128),
                                     (3, 77, 200, 136), (1, 1, 1, 1)])
def test_branch_gemm_kernel_matches_plain(cuda, dtype, n, m, k, f):
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(n, m, k, generator=g, device=cuda).to(dtype)
    w = (torch.randn(n, k, f, generator=g, device=cuda) * k ** -0.5).to(dtype)
    before = bops.launches
    got = bops.branch_gemm(x, w)
    assert bops.launches == before + 1
    _assert_kernel_close(got, branch_gemm_ref(x, w))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sizes,k,f", [((0, 37, 512, 5), 896, 4864),
                                       ((8, 24, 16), 128, 128),
                                       ((3, 0, 9), 48, 80)])
def test_grouped_gemm_kernel_matches_plain(cuda, dtype, sizes, k, f):
    g = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn(sum(sizes), k, generator=g, device=cuda).to(dtype)
    w = (torch.randn(len(sizes), k, f, generator=g, device=cuda)
         * k ** -0.5).to(dtype)
    before = gops.launches
    got = gops.grouped_gemm(x, w, sizes, gops.tile_table(sizes, cuda))
    assert gops.launches == before + 1
    _assert_kernel_close(got, grouped_gemm_ref(x, w, sizes))


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


def _branchy(device, width=4, d=64, tokens=32, seed=0):
    """Per block ``width`` (gemm → relu) branches that stack into fused
    steps, then a sum."""
    rng = np.random.default_rng(seed)
    g = OpGraph("branchy")
    cur = g.add("x", OpKind.INPUT, out_shape=(tokens, d))
    for blk in range(2):
        outs = []
        for b in range(width):
            w = torch.tensor(rng.standard_normal((d, d)) * 0.05,
                             dtype=torch.float32, device=device)
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


def _ragged(device, sizes=(8, 24, 16), k=128, f=128, bias=False, seed=3):
    rng = np.random.default_rng(seed)
    g = OpGraph("ragged")
    for i, m in enumerate(sizes):
        x = g.add(f"x{i}", OpKind.INPUT, out_shape=(m, k),
                  out_dtype=torch.float32)
        consts = (torch.tensor(rng.standard_normal((k, f)) * 0.05,
                               dtype=torch.float32, device=device),)
        if bias:
            consts += (torch.tensor(rng.standard_normal((f,)),
                                    dtype=torch.float32, device=device),)
        g.add(f"gemm{i}", OpKind.GEMM, [x], fn=_mm_b if bias else _mm,
              cost=gemm_cost(m, k, f, 4), fuse_sig=("gemm", k, f, bias),
              consts=consts, payload="matmul", out_shape=(m, f),
              out_dtype=torch.float32)
    return g


GRAPHS = {"branchy": _branchy, "ragged": _ragged,
          "ragged_bias": lambda d: _ragged(d, (0, 40, 8), bias=True)}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_cuda_graph_replay_matches_per_op_execution(cuda, name):
    g = GRAPHS[name](cuda)
    exe = compile_plan(schedule(g, "opara", "opara"))
    rng = np.random.default_rng(1)
    requests = [{n.name: torch.tensor(rng.standard_normal(n.out_shape) * 0.1,
                                      dtype=torch.float32, device=cuda)
                 for n in g if n.fn is None} for _ in range(2)]
    outs = [exe(r) for r in requests]          # record, then replay
    stats = exe.program_stats()
    assert exe.replay.recorded_launches == {
        "branch_gemm": int(stats["n_branch_gemm"]),
        "grouped_gemm": int(stats["n_grouped_gemm"])}
    assert stats["n_branch_gemm"] + stats["n_grouped_gemm"] >= 1
    # clones: the second request did not overwrite the first one's result
    for got, inputs in zip(outs, requests):
        want = run_sequential_uncompiled(g, inputs, exe.output_ids)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="recorded"):
        exe({k: torch.cat([v, v]) for k, v in requests[0].items()})
