"""The port's MLA (DeepSeek-V3) against the JAX package's.

Held on numpy-seeded inputs and on params drawn by the JAX ``init`` and
converted bit-exactly by ``repro_torch.bridge``:

* the MLA form of the paged-decode kernel's plain version
  (``paged_mla_decode_attention`` on CPU tensors) against the JAX package's
  wrapper: its Pallas kernel in interpret mode at 128-position pages, its
  reference at 4-position pages;
* ``mla_prefill``, ``mla_decode`` (dense latent slab) and
  ``mla_paged_decode`` (latent pages) against ``repro.models.attention``;
* the DeepSeek-V3 smoke ``Model``: the param tree (with the MTP head),
  prefill logits and latent caches, 3 dense and 3 paged decode steps, on
  the plain route and on the kernel route;
* the 4-layer op graph (3 dense-prefix MLA layers and one routed-MoE MLA
  layer) through the port's ``Session`` against the JAX package's captured
  program, and the cost-only export at full width;
* the serving engine, dense and paged, on the overload trace, paged ==
  dense inside the port, ``calibrate_schedule`` on the MLA export and the
  serve CLI.

Tolerances: fp32 1e-5 (the same arithmetic in another summation order);
bf16 2e-2 relative L2 over the tensor, the JAX package's bf16 differential
tolerance (the two frameworks round bf16 intermediates at other places; the
plain paged routine rounds the normalised probabilities to bf16 before the
weighted sum, as the model's plain attention does, and the Pallas kernel
rounds them after an online softmax).  Routing is forced to the
reference's choice in the Model test, as in ``test_torch_moe.py``.
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from benchmarks.bench_serving import _drive as ref_drive  # noqa: E402
from benchmarks.bench_serving import build_trace  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.scheduler import compile_plan as ref_compile  # noqa: E402
from repro.core.scheduler import schedule as ref_schedule  # noqa: E402
from repro.kernels.paged_decode import ops as ref_pops  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import ffn as ref_ffn  # noqa: E402
from repro.models.opgraph_export import build_lm_opgraph as ref_export  # noqa: E402
from repro.serving import AdmissionConfig as RefAdmission  # noqa: E402
from repro.serving import InferenceEngine as RefEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import V5E, Session, SessionConfig  # noqa: E402
from repro_torch.core.capture import run_sequential_uncompiled  # noqa: E402
from repro_torch.core.graph import dtype_name  # noqa: E402
from repro_torch.kernels.paged_decode import ops as pops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention, ffn  # noqa: E402
from repro_torch.models.opgraph_export import build_lm_opgraph  # noqa: E402
from repro_torch.serving import (AdmissionConfig, InferenceEngine,  # noqa: E402
                                 Request)

ARCH = "deepseek-v3-671b"
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


def _cfgs(dtype: str):
    jdt, tdt, _ = DTYPES[dtype]
    return (dataclasses.replace(ref_config(ARCH, smoke=True), dtype=jdt),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype=tdt))


# -- the MLA form of the paged-decode kernel's plain version ---------------------

def _mla_case(dtype, ps, seed, b=2, h=4, nope=16, rope=8, rank=16, maxp=3):
    rng = np.random.default_rng(seed)

    def arr(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(NP[dtype])

    n_pages = 1 + b * maxp
    bt = (rng.permutation(n_pages - 1) + 1).reshape(b, maxp).astype(np.int32)
    bt[1, 2:] = 0                                   # a trailing null page
    lengths = np.array([3 * ps - 1, ps + 1], np.int32)
    return (arr((b, h, nope)), arr((b, h, rope)), arr((n_pages, ps, rank)),
            arr((n_pages, ps, rope)), arr((rank, h, nope), nope ** -0.5),
            bt, lengths)


@pytest.mark.parametrize("dtype", sorted(NP))
@pytest.mark.parametrize("ps", [128, 4])
def test_paged_mla_plain_matches_the_reference_wrapper(dtype, ps):
    """At 128-position pages the JAX wrapper runs its Pallas kernel in
    interpret mode; at 4 it falls back to its reference."""
    arrays = _mla_case(dtype, ps, seed=ps)
    scale = (16 + 8) ** -0.5
    before = pops.mla_launches
    got = pops.paged_mla_decode_attention(
        *[bridge.array_to_tensor(a, "cpu") for a in arrays], scale)
    assert pops.mla_launches == before            # the CPU runs the plain form
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (2, 4, 16)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = ref_pops.paged_mla_decode_attention(
            *[jnp.asarray(a) for a in arrays], scale)
    # the JAX wrapper notes its fallback to the reference off the lattice
    assert bool(caught) == bool(ps % 128)
    _close(got, want, DTYPES[dtype][2])


def test_paged_mla_wrapper_checks_shapes_before_routing():
    arrays = [bridge.array_to_tensor(a, "cpu")
              for a in _mla_case("float32", 4, seed=1)]
    with pytest.raises(ValueError, match="shape mismatch"):
        pops.paged_mla_decode_attention(*arrays[:4], arrays[4][:8], *arrays[5:],
                                        1.0)
    with pytest.raises(ValueError, match="paged_mla_decode wants"):
        pops.paged_mla_decode_attention(arrays[0][0], *arrays[1:], 1.0)


def test_paged_mla_route_rule_by_dtype_width_page_size_and_strides():
    """The kernel's route from shapes, strides and alignment alone (CPU
    tensors carry them as well as CUDA ones): wgmma at DeepSeek-V3's rank
    512 and rope 64 with pages of 8, 16, 32 or a multiple of 64 positions
    and 16-byte strides and bases; simple for other bf16; fp32 for fp32."""
    bf = torch.bfloat16
    q_pe = torch.zeros(8, 128, 64, dtype=bf)
    for ps in (8, 16, 32, 64, 128, 256):
        ckv, kpe = torch.zeros(3, ps, 512, dtype=bf), torch.zeros(3, ps, 64,
                                                                   dtype=bf)
        assert pops.mla_route(q_pe, ckv, kpe) == "wgmma"
        assert pops.mla_route(q_pe.float(), ckv.float(),
                              kpe.float()) == "fp32"
    for ps in (4, 5, 48, 96):
        ckv, kpe = torch.zeros(3, ps, 512, dtype=bf), torch.zeros(3, ps, 64,
                                                                   dtype=bf)
        assert pops.mla_route(q_pe, ckv, kpe) == "simple"
    ckv, kpe = torch.zeros(3, 16, 512, dtype=bf), torch.zeros(3, 16, 64,
                                                              dtype=bf)
    assert pops.mla_route(q_pe, ckv[..., :256], kpe) == "simple"
    assert pops.mla_route(q_pe[..., :32], ckv, kpe[..., :32]) == "simple"
    # the model's q_pe: the rope columns of a wider projection (16-byte
    # strides and base) stay on wgmma; a base off 16 bytes does not
    wide = torch.zeros(8, 128, 192, dtype=bf)
    assert pops.mla_route(wide[..., 128:], ckv, kpe) == "wgmma"
    assert pops.mla_route(wide[..., 1:65], ckv, kpe) == "simple"


def test_paged_mla_wgmma_splits_fill_half_the_card_in_whole_tiles():
    from repro_torch.kernels.paged_decode.kernel import mla_wgmma_split_len
    # DeepSeek-V3's serving shape: 8 rows x 2 head groups, 4 splits of 256
    assert mla_wgmma_split_len(8, 128, 1024, 132) == 256
    for b, h, t in [(1, 128, 1024), (8, 128, 64), (64, 128, 1024),
                    (3, 20, 700), (1, 128, 8192)]:
        split = mla_wgmma_split_len(b, h, t, 132)
        n = -(-t // split)
        assert split % 64 == 0 and 1 <= n <= 8
        pairs = b * -(-h // 64)
        assert n == 1 or pairs * n <= 132 // 2


def test_paged_mla_simple_bf16_refuses_cpu_tensors():
    arrays = [bridge.array_to_tensor(a, "cpu")
              for a in _mla_case("bfloat16", 16, seed=2)]
    with pytest.raises(ValueError, match="CUDA"):
        pops.paged_mla_decode_simple_bf16(*arrays, 1.0)


# -- the attention functions -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _attn_setup(dtype: str):
    rcfg, cfg = _cfgs(dtype)
    rp = ref_attention.init_mla(jax.random.key(3), rcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, rcfg.d_model)).astype(NP[dtype])
    x1 = rng.standard_normal((2, 1, rcfg.d_model)).astype(NP[dtype])
    return rcfg, cfg, rp, _tree(rp), x, x1


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_prefill_matches_reference(dtype, use_kernels):
    rcfg, cfg, rp, p, x, _ = _attn_setup(dtype)
    tol = DTYPES[dtype][2]
    positions = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    ry, (rc, rr) = ref_attention.mla_prefill(rp, jnp.asarray(x), rcfg,
                                             jnp.asarray(positions))
    y, (c, r) = attention.mla_prefill(p, bridge.array_to_tensor(x, "cpu"),
                                      cfg, torch.from_numpy(positions).long(),
                                      use_kernels)
    _close(y, ry, tol)
    _close(c, rc, tol)
    _close(r, rr, tol)


def _latent_cache(dtype, b=2, t=16, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, 16)).astype(NP[dtype]),
            rng.standard_normal((b, t, 8)).astype(NP[dtype]))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_decode_matches_reference(dtype):
    rcfg, cfg, rp, p, _, x1 = _attn_setup(dtype)
    tol = DTYPES[dtype][2]
    c0, r0 = _latent_cache(dtype)
    pos = np.array([5, 13], np.int32)
    ry, (rc, rr) = ref_attention.mla_decode(
        rp, jnp.asarray(x1), (jnp.asarray(c0), jnp.asarray(r0)),
        jnp.asarray(pos), rcfg)
    cache = tuple(bridge.array_to_tensor(a, "cpu") for a in (c0, r0))
    y, (c, r) = attention.mla_decode(p, bridge.array_to_tensor(x1, "cpu"),
                                     cache, torch.from_numpy(pos), cfg)
    assert c is cache[0] and r is cache[1]        # written in place
    _close(y, ry, tol)
    _close(c, rc, tol)
    _close(r, rr, tol)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_paged_decode_matches_reference(dtype, use_kernels):
    """Through 4-position pages in a shuffled table, against the JAX
    package's ``use_kernels=True`` (its wrapper) route."""
    rcfg, cfg, rp, p, _, x1 = _attn_setup(dtype)
    tol = DTYPES[dtype][2]
    ps, maxp = 4, 4
    rng = np.random.default_rng(6)
    n_pages = 1 + 2 * maxp
    ckv = rng.standard_normal((n_pages, ps, 16)).astype(NP[dtype])
    kpe = rng.standard_normal((n_pages, ps, 8)).astype(NP[dtype])
    bt = (rng.permutation(n_pages - 1) + 1).reshape(2, maxp).astype(np.int32)
    pos = np.array([6, 14], np.int32)
    ry, (rck, rkp) = ref_attention.mla_paged_decode(
        rp, jnp.asarray(x1), (jnp.asarray(ckv), jnp.asarray(kpe)),
        jnp.asarray(bt), jnp.asarray(pos), rcfg, use_kernels=True)
    pages = tuple(bridge.array_to_tensor(a, "cpu") for a in (ckv, kpe))
    y, (ck, kp) = attention.mla_paged_decode(
        p, bridge.array_to_tensor(x1, "cpu"), pages, torch.from_numpy(bt),
        torch.from_numpy(pos), cfg, use_kernels)
    assert ck is pages[0] and kp is pages[1]      # written in place
    _close(y, ry, tol)
    _close(ck, rck, tol)
    _close(kp, rkp, tol)


def test_latent_cache_shapes():
    _, cfg = _cfgs("float32")
    c, r = attention.init_cache(cfg, 3, 10, device="cpu")
    assert tuple(c.shape) == (3, 10, 16) and tuple(r.shape) == (3, 10, 8)
    c, r = attention.init_paged_cache(cfg, 7, 4, device="cpu")
    assert tuple(c.shape) == (7, 4, 16) and tuple(r.shape) == (7, 4, 8)


# -- the DeepSeek-V3 smoke model --------------------------------------------------

B, PROMPT, CACHE, PAGE = 2, 11, 24, 4


@functools.lru_cache(maxsize=None)
def _model_setup(dtype: str):
    rcfg, cfg = _cfgs(dtype)
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
    package's model; also returns every routing decision in call order."""
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
def test_deepseek_prefill_decode_and_paged_decode_match_reference(
        dtype, use_kernels, monkeypatch):
    """The port takes the reference's expert choices (its combine weights
    from its own router scores), as in ``test_torch_moe.py``; the share of
    tokens whose own choice differs is held separately: none in fp32, at
    most 10% in bf16."""
    jdt, tdt, tol = DTYPES[dtype]
    rcfg, cfg, rmodel, rparams, params, tokens, steps = _model_setup(dtype)
    maxp = CACHE // PAGE
    tables = np.random.default_rng(3).permutation(
        np.arange(1, 1 + B * maxp)).reshape(B, maxp).astype(np.int32)
    want, routes = _reference_run(rmodel, rparams, tokens, steps, tables,
                                  jdt, monkeypatch)
    assert len(routes) == 1 + 2 * len(steps)      # one MoE layer a pass

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
    for (rc, rr), (c, r) in zip(want["prefill"][1], caches):
        assert tuple(c.shape) == (c.shape[0], B, CACHE, 16)
        _close(c, rc, tol)
        _close(r, rr, tol)
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
    for (rc, rr), (c, r) in zip(want["caches"], caches):
        _close(c, rc, tol)
        _close(r, rr, tol)
    share = float(torch.cat(flipped).float().mean())
    assert share <= (0.0 if dtype == "float32" else 0.1), share


def test_deepseek_init_matches_the_reference_tree():
    """``Model.init`` draws the reference's tree: MLA attention in both
    stacks, a dense-prefix stack of 3 layers, an MoE stack, and the MTP
    head (projection, one MoE block, norm)."""
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
    assert ours["stacks"][0]["attn"]["wk_b"]["w"].shape[0] == 3
    assert "router" in ours["mtp"]["block"]["ffn"]
    assert tuple(ours["mtp"]["proj"]["w"].shape) == (128, 64)


# -- the op graph -------------------------------------------------------------------

def test_mla_op_graph_matches_reference(tmp_path):
    rcfg, cfg = _cfgs("float32")
    rparams = RefModel(rcfg).init(jax.random.key(0))
    rg = ref_export(rcfg, batch=1, seq=16, params=rparams, n_layers=4)
    pg = build_lm_opgraph(cfg, batch=1, seq=16, params=_tree(rparams),
                          n_layers=4)
    norm = tuple(row[:3] + (dtype_name(n.out_dtype),) + row[4:]
                 for row, n in zip(rg.node_signature(), rg))
    assert [n.name for n in pg] == [n.name for n in rg]
    assert norm == pg.node_signature()
    assert sum(".q_lat" in n.name for n in pg) == 4
    rexe = ref_compile(ref_schedule(rg, "opara", "opara"),
                       gemm_kernel="pallas")
    sess = Session(SessionConfig(device="cpu", hw=V5E,
                                 calib_dir=str(tmp_path)))
    tok = np.random.default_rng(5).integers(0, rcfg.vocab_size,
                                            (1, 16)).astype(np.int32)
    model = sess.compile(pg, inputs={0: torch.from_numpy(tok).long()})
    assert model.executable.program_stats()["n_grouped_gemm"] >= 1
    want = rexe({"tokens": jnp.asarray(tok)})
    got = model({"tokens": torch.from_numpy(tok)})
    _close(got[-1], want[-1], 1e-5)
    seq = run_sequential_uncompiled(pg, {"tokens": torch.from_numpy(tok)},
                                    model.executable.output_ids)
    _close(got[-1], seq[-1], 1e-5)


def test_mla_cost_only_export_matches_reference_at_full_width():
    rg = ref_export(ref_config(ARCH), batch=1, seq=64, n_layers=4)
    pg = build_lm_opgraph(get_config(ARCH), batch=1, seq=64, n_layers=4)
    assert [n.name for n in pg] == [n.name for n in rg]
    assert pg.node_signature() == rg.node_signature()


# -- serving ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _engines():
    rcfg, cfg = _cfgs("float32")
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
def test_deepseek_engine_matches_reference_on_overload_trace(paged):
    (ref, ref_done), (port, port_done) = _served(paged)
    assert port.paged is paged
    assert port_done == ref_done
    assert port.fault_stats == ref.fault_stats
    assert port.tick == ref.tick
    assert port.fault_stats["expired_requests"] >= 1
    assert port.kv_cache_bytes() == ref.kv_cache_bytes()


def test_deepseek_paged_equals_dense_and_kernel_route_equals_plain():
    dense = _served(False)[1][1]
    assert _served(True)[1][1] == dense
    assert _served(True, True)[1][1] == dense


def test_paged_matches_dense_on_mla_moe_smoke():
    """The port's counterpart of the JAX package's serving test of the same
    name: the latent-page path emits the dense engine's streams."""
    _, _, cfg, params = _engines()
    model = Model(cfg)

    def run(paged):
        engine = InferenceEngine(model, params, max_slots=2, max_len=32,
                                 seed=9, paged_kv=paged, page_size=4)
        engine.submit(Request(rid="a", prompt=[3, 17, 42, 9], max_tokens=5))
        engine.submit(Request(rid="b", prompt=[11, 2], max_tokens=5))
        return _terminal_map(engine.run(200))

    assert run(True) == run(False)


def test_dense_gather_rung_writes_latent_pages_back():
    """The paged → dense-gather rung gathers the 3-D latent pages into a
    dense slab, decodes, and scatters the new position back: the next
    paged step reads it."""
    _, _, cfg, params = _engines()
    engine = InferenceEngine(Model(cfg), params, max_slots=2, max_len=32,
                             seed=1, paged_kv=True, page_size=4)
    for rid, prompt in (("a", [3, 17, 42, 9, 5]), ("b", [11, 2])):
        engine.submit(Request(rid=rid, prompt=prompt, max_tokens=6))
    engine.step()
    engine.step()
    before = [leaf.clone() for kv in engine.caches for leaf in kv]
    gathered = engine._dense_gather_decode()
    rows = [i for i, r in enumerate(engine.slots) if r is not None]
    paged = engine._paged_step()
    assert len(rows) == 2
    _close(gathered[rows], paged[rows], 1e-5)
    changed = [bool((leaf != old).any()) for leaf, old in
               zip((leaf for kv in engine.caches for leaf in kv), before)]
    assert all(changed) and before[0].dim() == 4   # [L, P, ps, rank]


def test_calibrate_schedule_works_on_the_mla_export(tmp_path):
    _, _, cfg, params = _engines()
    sess = Session(SessionConfig(device="cpu", hw=V5E,
                                 calib_dir=str(tmp_path)))
    engine = InferenceEngine(Model(cfg), params, max_slots=2, max_len=32,
                             session=sess)
    plan = engine.calibrate_schedule(n_layers=4)
    assert plan is engine.schedule_plan
    assert any(".q_lat" in n.name for n in plan.graph)
    assert all(n.cost.measured_us is not None
               for n in plan.graph if n.fn is not None)
    assert sess.cache_stats()["calib_degraded_analytic"] == 0


def test_serve_cli_runs_the_deepseek_smoke_config_on_the_cpu():
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-tokens", "4"]) == 0
