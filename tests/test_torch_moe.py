"""The port's Mixture-of-Experts family (Kimi-K2) against the JAX package's.

Held on numpy-seeded inputs and on params drawn by the JAX ``init`` and
converted bit-exactly by ``repro_torch.bridge``:

* the ``moe_gemm`` kernel's plain version against ``moe_mlp_ref`` and the
  Pallas kernel in interpret mode (``bc=8, bf=128``, d 128);
* ``route``, the one-hot and the sort dispatch (sort vs dense, capacity
  drops, the aux-free bias, more than 32 experts so that ``moe_ffn`` takes
  the sort path) against ``repro.models.ffn``;
* the Kimi-K2 smoke ``Model``: prefill, 3 decode steps and 3 paged decode
  steps, on the plain route and on the kernel route;
* the routed-MoE op graph (3 layers, capacity scale 1.0 and 0.25) through
  the port's ``Session`` against the JAX package's captured program;
* the serving engine, dense and paged, on the overload trace.

Tolerances: fp32 1e-5 (the same arithmetic in another summation order);
bf16 2e-2 relative L2 over the tensor, the JAX package's bf16 differential
tolerance (the two frameworks round bf16 intermediates at other places, and
the kernel route keeps h in fp32 where the reference's plain route rounds
it, ROADMAP C4).  Routing indices are compared exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from benchmarks.bench_serving import _drive as ref_drive  # noqa: E402
from benchmarks.bench_serving import build_trace  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.configs.base import MoEConfig as RefMoEConfig  # noqa: E402
from repro.core.scheduler import compile_plan as ref_compile  # noqa: E402
from repro.core.scheduler import schedule as ref_schedule  # noqa: E402
from repro.kernels.moe_gemm.kernel import moe_mlp_pallas  # noqa: E402
from repro.kernels.moe_gemm.ref import moe_mlp_ref as jax_moe_ref  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models import ffn as ref_ffn  # noqa: E402
from repro.models.opgraph_export import build_lm_opgraph as ref_export  # noqa: E402
from repro.serving import AdmissionConfig as RefAdmission  # noqa: E402
from repro.serving import InferenceEngine as RefEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.core import V5E, Session, SessionConfig  # noqa: E402
from repro_torch.core.capture import run_sequential_uncompiled  # noqa: E402
from repro_torch.core.graph import dtype_name  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as mops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import ffn  # noqa: E402
from repro_torch.models.opgraph_export import build_lm_opgraph  # noqa: E402
from repro_torch.serving import (AdmissionConfig, InferenceEngine,  # noqa: E402
                                 Request)

ARCH = "kimi-k2-1t-a32b"
NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(port, ref, tol):
    got, want = _np(port), _np(ref)
    assert got.shape == want.shape
    if tol == DTYPES["bfloat16"][2]:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= tol, f"relative L2 {rel:.3g} > {tol}"
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _tree(params):
    return bridge.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")


# -- the moe_gemm kernel's plain version ---------------------------------------

@pytest.mark.parametrize("dtype", sorted(NP))
@pytest.mark.parametrize("e,c,d,f,lattice", [
    (2, 8, 128, 128, True), (4, 16, 128, 256, True), (3, 5, 40, 24, False),
    (2, 1, 56, 136, False), (3, 0, 16, 8, False)])
def test_moe_mlp_plain_matches_jax_ref_and_pallas(dtype, e, c, d, f,
                                                  lattice):
    rng = np.random.default_rng(e * 100 + c)
    arrs = [(rng.standard_normal(s) * sc).astype(NP[dtype]) for s, sc in (
        ((e, c, d), 0.1), ((e, d, f), 0.05), ((e, d, f), 0.05),
        ((e, f, d), 0.05))]
    launches = mops.launches
    got = mops.moe_mlp(*[bridge.array_to_tensor(a, "cpu") for a in arrs])
    assert mops.launches == launches          # the CPU runs the plain version
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (e, c, d)
    tol = DTYPES[dtype][2]
    if c == 0:
        return
    jarrs = [jnp.asarray(a) for a in arrs]
    _close(got, jax_moe_ref(*jarrs), tol)
    if lattice:
        _close(got, moe_mlp_pallas(*jarrs, bc=8, bf=128, interpret=True),
               tol)


def test_moe_mlp_checks_shapes_before_routing():
    x = torch.zeros((2, 3, 8))
    w = torch.zeros((2, 8, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        mops.moe_mlp(x, w, w, torch.zeros((2, 8, 4)))
    with pytest.raises(ValueError, match="moe_mlp wants"):
        mops.moe_mlp(x[0], w, w, w.transpose(1, 2))


# -- empty experts: the property the kernel's expert skip rests on ------------

@pytest.mark.parametrize("dtype", sorted(NP))
@pytest.mark.parametrize("empty", [(1,), (0, 2), (0, 1, 2, 3)],
                         ids=["one", "some", "all"])
def test_empty_experts_give_exact_positive_zero_rows(dtype, empty):
    """An expert whose capacity rows are all zero gets rows of +0 from the
    port's plain version, the JAX package's ``moe_mlp_ref`` and its Pallas
    kernel (interpret mode): the kernel may skip its weights and write +0.
    The other experts still agree as before."""
    e, c, d, f = 4, 8, 128, 128
    rng = np.random.default_rng(len(empty))
    arrs = [(rng.standard_normal(s) * sc).astype(NP[dtype]) for s, sc in (
        ((e, c, d), 0.1), ((e, d, f), 0.05), ((e, d, f), 0.05),
        ((e, f, d), 0.05))]
    arrs[0][list(empty)] = 0
    got = mops.moe_mlp(*[bridge.array_to_tensor(a, "cpu") for a in arrs])
    jarrs = [jnp.asarray(a) for a in arrs]
    outs = {"port": got, "jax ref": jax_moe_ref(*jarrs),
            "pallas": moe_mlp_pallas(*jarrs, bc=8, bf=128, interpret=True)}
    for name, out in outs.items():
        rows = _np(out)[list(empty)]
        assert (rows == 0).all(), name
        assert not np.signbit(rows).any(), name
    _close(got, outs["jax ref"], DTYPES[dtype][2])
    _close(got, outs["pallas"], DTYPES[dtype][2])


def _operand(shape, dtype=torch.bfloat16, offset=0):
    """A tensor of ``shape`` over two elements of storage, its base
    ``offset`` elements in: the route reads dtype, shape and base only."""
    return torch.zeros(2, dtype=dtype).as_strided(shape, [0] * len(shape),
                                                  offset)


def _expert_operands(e, c, d, f, dtype=torch.bfloat16, offsets=(0,) * 4):
    shapes = ((e, c, d), (e, d, f), (e, d, f), (e, f, d))
    return [_operand(s, dtype, o) for s, o in zip(shapes, offsets)]


@pytest.mark.parametrize("shape,dtype,offsets,want", [
    ((384, 1, 7168, 2048), torch.bfloat16, None, "wgmma"),  # Kimi-K2 tick
    ((384, 13, 7168, 2048), torch.bfloat16, None, "wgmma"),  # 512 tokens
    ((384, 18, 7168, 2048), torch.bfloat16, None, "wgmma"),  # 700 tokens
    ((256, 27, 7168, 2048), torch.bfloat16, None, "wgmma"),  # DeepSeek-V3
    ((8, 3, 64, 32), torch.bfloat16, None, "wgmma"),         # smoke widths
    ((3, 5, 200, 136), torch.bfloat16, None, "wgmma"),       # off the tiles
    ((4096, 1, 64, 32), torch.bfloat16, None, "wgmma"),      # the most experts
    ((3, 5, 100, 136), torch.bfloat16, None, "simple"),      # d % 8 != 0
    ((3, 5, 200, 36), torch.bfloat16, None, "simple"),       # f % 8 != 0
    ((4097, 1, 64, 32), torch.bfloat16, None, "simple"),     # list too long
    ((3, 5, 64, 32), torch.bfloat16, (1, 0, 0, 0), "simple"),  # buf base
    ((3, 5, 64, 32), torch.bfloat16, (0, 0, 0, 1), "simple"),  # down base
    ((64, 1, 7168, 2048), torch.float32, None, "fp32"),
    ((3, 5, 100, 36), torch.float32, None, "fp32"),
])
def test_route_rule_sends_only_tma_readable_bf16_to_wgmma(shape, dtype,
                                                          offsets, want):
    ops = _expert_operands(*shape, dtype=dtype,
                           offsets=offsets or (0,) * 4)
    assert mops.route(*ops) == want


def test_forced_simple_route_needs_cuda_tensors():
    ops = [torch.zeros(s, dtype=torch.bfloat16) for s in
           ((2, 3, 8), (2, 8, 8), (2, 8, 8), (2, 8, 8))]
    with pytest.raises(ValueError, match="CUDA"):
        mops.moe_mlp_simple_bf16(*ops)


# -- routing and dispatch ------------------------------------------------------

def _cfgs(n_experts=8, top_k=2, cf=2.0, aux_free=False):
    common = dict(name="moe-test", family="moe", n_layers=1, d_model=32,
                  n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64)
    moe = dict(n_experts=n_experts, top_k=top_k, d_expert=16, n_shared=1,
               capacity_factor=cf, router_aux_free=aux_free)
    return (RefModelConfig(**common, moe=RefMoEConfig(**moe),
                           dtype=jnp.float32),
            ModelConfig(**common, moe=MoEConfig(**moe), dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def _moe_setup(n_experts, top_k, cf, aux_free, bias_seed=None):
    rcfg, cfg = _cfgs(n_experts, top_k, cf, aux_free)
    rp = ref_ffn.init_moe(jax.random.key(0), rcfg)
    if bias_seed is not None:
        bias = np.random.default_rng(bias_seed).standard_normal(n_experts)
        rp["router"]["bias"] = jnp.asarray(bias * 0.3, jnp.float32)
    x = np.random.default_rng(1).standard_normal((2, 8, 32)).astype(
        np.float32)
    return rcfg, cfg, rp, _tree(rp), x


@pytest.mark.parametrize("aux_free", [False, True])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_route_matches_reference(top_k, aux_free):
    rcfg, cfg, rp, p, x = _moe_setup(8, top_k, 2.0, aux_free, 3)
    xf = x.reshape(-1, 32)
    rw, ridx, raux = ref_ffn.route(rp["router"], jnp.asarray(xf), rcfg.moe)
    w, idx, aux = ffn.route(p["router"], torch.from_numpy(xf), cfg.moe)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    _close(w, rw, 1e-5)
    _close(w.sum(-1), np.ones(16, np.float32), 1e-5)
    _close(aux["load"], raux["load"], 1e-6)
    _close(aux["aux_loss"], raux["aux_loss"], 1e-5)


@pytest.mark.parametrize("dispatch", ["moe_ffn_dense", "moe_ffn_sort"])
@pytest.mark.parametrize("top_k,cf,aux_free", [
    (1, 8.0, False), (2, 8.0, True), (4, 8.0, False), (2, 0.25, False),
    (2, 0.25, True)])
def test_dispatch_matches_reference(dispatch, top_k, cf, aux_free):
    """Both dispatches against the JAX package's, with and without capacity
    drops (cf 0.25)."""
    rcfg, cfg, rp, p, x = _moe_setup(8, top_k, cf, aux_free)
    ry, raux = getattr(ref_ffn, dispatch)(rp, jnp.asarray(x), rcfg)
    y, aux = getattr(ffn, dispatch)(p, torch.from_numpy(x), cfg)
    _close(y, ry, 1e-5)
    _close(aux["load"], raux["load"], 1e-6)


@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_sort_equals_dense_and_capacity_drops(cf):
    _, cfg, _, p, x = _moe_setup(8, 2, cf, False)
    xt = torch.from_numpy(x)
    y_dense, aux_d = ffn.moe_ffn_dense(p, xt, cfg)
    y_sort, aux_s = ffn.moe_ffn_sort(p, xt, cfg)
    _close(y_sort, y_dense, 1e-5)
    _close(aux_s["load"], aux_d["load"], 1e-6)
    if cf < 1:
        y_big, _ = ffn.moe_ffn_dense(p, xt, _cfgs(8, 2, 8.0)[1])
        assert float((y_big - y_dense).abs().max()) > 1e-6


def test_moe_ffn_takes_the_sort_path_above_32_experts():
    rcfg, cfg, rp, p, x = _moe_setup(40, 2, 1.25, True, 5)
    ry, _ = ref_ffn.moe_ffn(rp, jnp.asarray(x), rcfg)
    y, _ = ffn.moe_ffn(p, torch.from_numpy(x), cfg)
    _close(y, ry, 1e-5)
    _close(y, ffn.moe_ffn_dense(p, torch.from_numpy(x), cfg)[0], 1e-5)


def test_aux_free_bias_steers_routing():
    _, cfg, _, p, _ = _moe_setup(4, 1, 2.0, True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (64, 32)).astype(np.float32))
    count0 = int((ffn.route(p["router"], x, cfg.moe)[1] == 0).sum())
    biased = {**p["router"], "bias": p["router"]["bias"].clone()}
    biased["bias"][0] += 10.0
    count1 = int((ffn.route(biased, x, cfg.moe)[1] == 0).sum())
    assert count1 > count0


def test_router_noise_draws_from_the_generator():
    _, cfg, _, p, x = _moe_setup(8, 2, 2.0, False)
    noisy = dataclasses.replace(cfg.moe, router_noise=5.0)
    xf = torch.from_numpy(x.reshape(-1, 32))
    plain = ffn.route(p["router"], xf, noisy)[1]
    a = ffn.route(p["router"], xf, noisy, torch.Generator().manual_seed(1))[1]
    b = ffn.route(p["router"], xf, noisy, torch.Generator().manual_seed(1))[1]
    assert torch.equal(a, b) and not torch.equal(a, plain)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_expert_mlp_routes_in_bf16(use_kernels):
    """ROADMAP C4: the plain route rounds silu(x@gate) and x@up to bf16 as
    the reference's inline path does; the kernel route keeps h in fp32 as
    ``moe_mlp_ref`` does.  Each is held to its counterpart."""
    rng = np.random.default_rng(11)
    arrs = [(rng.standard_normal(s) * 0.5).astype(ml_dtypes.bfloat16)
            for s in ((4, 6, 32), (4, 32, 16), (4, 32, 16), (4, 16, 32))]
    experts = {"gate": arrs[1], "up": arrs[2], "down": arrs[3]}
    got = ffn._expert_mlp(_tree(experts), bridge.array_to_tensor(arrs[0],
                                                                 "cpu"),
                          use_kernels)
    if use_kernels:
        want = jax_moe_ref(*[jnp.asarray(a) for a in arrs])
    else:
        want = ref_ffn._expert_mlp(
            jax.tree_util.tree_map(jnp.asarray, experts),
            jnp.asarray(arrs[0]), False)
    _close(got, want, 2e-2)


# -- the Kimi-K2 smoke model -----------------------------------------------------

B, PROMPT, CACHE, PAGE = 2, 11, 24, 4


@functools.lru_cache(maxsize=None)
def _model_setup(dtype: str):
    jdt, tdt, _ = DTYPES[dtype]
    rcfg = dataclasses.replace(ref_config(ARCH, smoke=True), dtype=jdt)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=tdt)
    rmodel = RefModel(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, rcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(1, rcfg.vocab_size, (3, B)).astype(np.int32)
    return rcfg, cfg, rmodel, rparams, _tree(rparams), tokens, steps


def _to_pages(dense_leaf, tables, num_pages):
    leaf = _np(dense_leaf)
    pages = np.zeros((leaf.shape[0], num_pages, PAGE) + leaf.shape[3:],
                     np.float32)
    for b, table in enumerate(tables):
        for i, page in enumerate(table):
            pages[:, page] = leaf[:, b, i * PAGE:(i + 1) * PAGE]
    return pages


def _reference_run(rmodel, rparams, tokens, steps, tables, jdt,
                   monkeypatch):
    """Prefill, then per step a dense and a paged decode, on the JAX
    package's model; also returns every routing decision in call order
    (jit off, so the scan over layers runs its body eagerly)."""
    routes, out = [], {"decode": [], "paged": []}
    route = ref_ffn.route

    def recording(p, x, e, rng=None):
        w, idx, aux = route(p, x, e, rng)
        routes.append(np.asarray(idx))
        return w, idx, aux

    with monkeypatch.context() as m, jax.disable_jit():
        m.setattr(ref_ffn, "route", recording)
        logits, caches = rmodel.prefill(rparams,
                                        {"tokens": jnp.asarray(tokens)},
                                        cache_len=CACHE)
        out["prefill"] = (logits, caches)
        num_pages = 1 + tables.size
        pages = [tuple(jnp.asarray(_to_pages(x, tables, num_pages), jdt)
                       for x in kv) for kv in caches]
        for i, tok in enumerate(steps):
            pos = jnp.full((B,), PROMPT + i, jnp.int32)
            logits, caches = rmodel.decode(rparams, jnp.asarray(tok), caches,
                                           pos)
            out["decode"].append(logits)
            logits, pages = rmodel.paged_decode(rparams, jnp.asarray(tok),
                                                pages, jnp.asarray(tables),
                                                pos)
            out["paged"].append(logits)
        out["caches"] = caches
    return out, routes


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kimi_prefill_decode_and_paged_decode_match_reference(
        dtype, use_kernels, monkeypatch):
    """Routing is discrete: a bf16 ulp upstream of the router can swap a
    token's k-th and (k+1)-th experts.  So the port takes the reference's
    expert choices (its combine weights from its own router scores), which
    keeps every continuous part comparable at the dtype's tolerance, and the
    share of tokens whose own choice differs is held separately: none in
    fp32, at most 10% in bf16."""
    jdt, tdt, tol = DTYPES[dtype]
    rcfg, cfg, rmodel, rparams, params, tokens, steps = _model_setup(dtype)
    maxp = CACHE // PAGE
    tables = np.random.default_rng(3).permutation(
        np.arange(1, 1 + B * maxp)).reshape(B, maxp).astype(np.int32)
    want, routes = _reference_run(rmodel, rparams, tokens, steps, tables,
                                  jdt, monkeypatch)
    assert len(routes) == 2 * (1 + 2 * len(steps))    # 2 MoE layers a pass

    ref_choice = iter(routes)
    flipped = []
    route = ffn.route

    def forced(p, x, e, generator=None):
        _, idx, aux = route(p, x, e, generator)
        ridx = torch.tensor(next(ref_choice), dtype=idx.dtype)
        flipped.append((idx.sort(-1).values != ridx.sort(-1).values)
                       .any(-1))
        logits = torch.matmul(x.float(), p["w"])
        scores = (torch.sigmoid(logits) if e.router_aux_free
                  else torch.softmax(logits, dim=-1))
        w = torch.gather(scores, -1, ridx)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), ridx, aux

    monkeypatch.setattr(ffn, "route", forced)
    model = Model(cfg, use_kernels=use_kernels)
    logits, caches = model.prefill(
        params, {"tokens": torch.from_numpy(tokens).long()}, cache_len=CACHE)
    _close(logits, want["prefill"][0], tol)
    assert len(caches) == 2                       # dense prefix + MoE stack
    for (rk, rv), (k, v) in zip(want["prefill"][1], caches):
        _close(k, rk, tol)
        _close(v, rv, tol)
    num_pages = 1 + B * maxp
    pages = [tuple(torch.from_numpy(_to_pages(x, tables, num_pages)).to(tdt)
                   for x in kv) for kv in want["prefill"][1]]
    for i, tok in enumerate(steps):
        pos = torch.full((B,), PROMPT + i, dtype=torch.int32)
        tok_t = torch.from_numpy(tok).long()
        logits, caches = model.decode(params, tok_t, caches, pos)
        _close(logits, want["decode"][i], tol)
        logits, pages = model.paged_decode(params, tok_t, pages,
                                           torch.from_numpy(tables), pos)
        _close(logits, want["paged"][i], tol)
    for (rk, rv), (k, v) in zip(want["caches"], caches):
        _close(k, rk, tol)
        _close(v, rv, tol)
    share = float(torch.cat(flipped).float().mean())
    assert share <= (0.0 if dtype == "float32" else 0.1), share


def test_kimi_init_matches_the_reference_tree():
    """``Model.init`` draws the reference's tree: a dense-prefix stack with
    a wide MLP, then an MoE stack with router, experts and shared expert."""
    _, cfg, _, _, theirs, _, _ = _model_setup("bfloat16")
    ours = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")

    def walk(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype

    walk(ours, theirs)
    assert "router" in ours["stacks"][1]["ffn"]
    assert "gate" in ours["stacks"][0]["ffn"]


# -- the routed op graph ---------------------------------------------------------

@pytest.mark.parametrize("cap_scale", [1.0, 0.25])
def test_routed_moe_op_graph_matches_reference(cap_scale, tmp_path):
    rcfg = dataclasses.replace(ref_config(ARCH, smoke=True), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              dtype=torch.float32)
    rparams = RefModel(rcfg).init(jax.random.key(0))
    rg = ref_export(rcfg, batch=1, seq=32, params=rparams, n_layers=3,
                    moe_cap_scale=cap_scale)
    pg = build_lm_opgraph(cfg, batch=1, seq=32, params=_tree(rparams),
                          n_layers=3, moe_cap_scale=cap_scale)
    norm = tuple(row[:3] + (dtype_name(n.out_dtype),) + row[4:]
                 for row, n in zip(rg.node_signature(), rg))
    assert norm == pg.node_signature()
    # unequal capacities (at a quarter of them, 2-4 rows, most routed
    # pairs overflow)
    caps = [n.out_shape[0] for n in pg if ".dispatch" in n.name]
    assert len(set(caps)) > 1
    if cap_scale < 1:
        assert max(caps) <= 4
    rexe = ref_compile(ref_schedule(rg, "opara", "opara"),
                       gemm_kernel="pallas")
    sess = Session(SessionConfig(device="cpu", hw=V5E,
                                 calib_dir=str(tmp_path)))
    tok = np.random.default_rng(5).integers(0, rcfg.vocab_size,
                                            (1, 32)).astype(np.int32)
    model = sess.compile(pg, inputs={0: torch.from_numpy(tok).long()})
    assert model.executable.program_stats()["n_grouped_gemm"] >= 1
    want = rexe({"tokens": jnp.asarray(tok)})
    got = model({"tokens": torch.from_numpy(tok)})
    _close(got[-1], want[-1], 1e-5)
    seq = run_sequential_uncompiled(pg, {"tokens": torch.from_numpy(tok)},
                                    model.executable.output_ids)
    _close(got[-1], seq[-1], 1e-5)


def test_uniform_cost_only_export_matches_reference():
    rcfg = ref_config(ARCH)
    cfg = get_config(ARCH)
    rg = ref_export(rcfg, batch=1, seq=64, n_layers=3)
    pg = build_lm_opgraph(cfg, batch=1, seq=64, n_layers=3)
    assert [n.name for n in pg] == [n.name for n in rg]
    assert pg.node_signature() == rg.node_signature()


# -- serving ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _engines():
    rcfg = dataclasses.replace(ref_config(ARCH, smoke=True), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              dtype=torch.float32)
    rmodel = RefModel(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    return rmodel, rparams, cfg, _tree(rparams)


def _drive(engine, trace, max_ticks: int = 400):
    """``benchmarks.bench_serving._drive`` with the port's ``Request``."""
    submitted, idx = [], 0
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


@functools.lru_cache(maxsize=None)
def _served(paged: bool, use_kernels: bool = False):
    rmodel, rparams, cfg, params = _engines()
    trace = build_trace(n=12, seed=7)
    common = dict(max_slots=2, max_len=64, seed=3, paged_kv=paged,
                  page_size=16)
    ref = RefEngine(rmodel, rparams,
                    admission=RefAdmission(policy="edf", preemption=True),
                    **common)
    port = InferenceEngine(Model(cfg, use_kernels=use_kernels), params,
                           admission=AdmissionConfig(policy="edf",
                                                     preemption=True),
                           **common)
    return (ref, _terminal_map(ref_drive(ref, trace))), \
        (port, _terminal_map(_drive(port, trace)))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_kimi_engine_matches_reference_on_overload_trace(paged):
    (ref, ref_done), (port, port_done) = _served(paged)
    assert port.paged is paged
    assert port_done == ref_done
    assert port.fault_stats == ref.fault_stats
    assert port.tick == ref.tick
    assert port.fault_stats["expired_requests"] >= 1
    assert port.kv_cache_bytes() > 0


def test_kimi_paged_equals_dense_and_kernel_route_equals_plain():
    dense = _served(False)[1][1]
    assert _served(True)[1][1] == dense
    assert _served(False, True)[1][1] == dense


def test_calibrate_schedule_works_on_routed_moe(tmp_path):
    _, _, cfg, params = _engines()
    sess = Session(SessionConfig(device="cpu", hw=V5E,
                                 calib_dir=str(tmp_path)))
    engine = InferenceEngine(Model(cfg), params, max_slots=2, max_len=32,
                             session=sess)
    plan = engine.calibrate_schedule(n_layers=2)
    assert plan is engine.schedule_plan
    assert any(".dispatch" in n.name for n in plan.graph)
    assert all(n.cost.measured_us is not None
               for n in plan.graph if n.fn is not None)
    assert sess.cache_stats()["calib_degraded_analytic"] == 0


def test_serve_cli_runs_the_kimi_smoke_config_on_the_cpu():
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-tokens", "4"]) == 0
