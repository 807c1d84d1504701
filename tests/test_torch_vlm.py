"""The vision-language family (llava-next-mistral-7b) against the JAX
package's, on its smoke config (2 layers, d 64, 4/2 heads, 8 patches of 24
features).

Params come from the JAX ``init`` and are converted bit-exactly by
``repro_torch.bridge`` (the ``frontend`` projector included); tokens and
patch embeddings come from numpy.

* the config (full and smoke) and ``Model.init``'s tree;
* ``Model.prefill`` with ``extra_embeds`` (the projector's rows before the
  text), then 3 dense decode steps, on the port's plain and kernel routes
  (on the CPU the kernels' plain versions) against the reference's;
* the op graph, text only as the reference's (ROADMAP C13): node for node
  with equal digests, lowered steps and ``program_stats()``, its output
  against the reference's captured program and against the port's
  text-only ``lm_forward`` without RoPE (the export applies none, C5);
* the serving engine (text prompts, as the reference's engine serves them)
  on the overload trace, dense and paged, against the reference's engine,
  paged equal to dense.

Tolerances: fp32 1e-5; bf16 relative L2 <= 2e-2 over the tensor, the JAX
package's bf16 differential tolerance.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from benchmarks.bench_serving import _drive as ref_drive  # noqa: E402
from benchmarks.bench_serving import build_trace  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.scheduler import compile_plan as ref_compile  # noqa: E402
from repro.core.scheduler import schedule as ref_schedule  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models.opgraph_export import build_lm_opgraph as ref_export  # noqa: E402
from repro.serving import AdmissionConfig as RefAdmission  # noqa: E402
from repro.serving import InferenceEngine as RefEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import V5E, Session, SessionConfig  # noqa: E402
from repro_torch.core.scheduler import compile_plan, schedule  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.opgraph_export import build_lm_opgraph  # noqa: E402
from repro_torch.models.transformer import lm_forward  # noqa: E402
from repro_torch.serving import (AdmissionConfig, InferenceEngine,  # noqa: E402
                                 Request)

ARCH = "llava-next-mistral-7b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, PROMPT, CACHE = 2, 7, 24


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


@functools.lru_cache(maxsize=None)
def _setup(dtype: str):
    jdt, tdt, _ = DTYPES[dtype]
    rcfg = dataclasses.replace(ref_config(ARCH, smoke=True), dtype=jdt)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=tdt)
    rmodel = RefModel(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    params = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                               "cpu")
    rng = np.random.default_rng(11)
    fe = cfg.frontend
    images = rng.standard_normal((B, fe.n_tokens, fe.feat_dim)).astype(
        np.float32)
    tokens = rng.integers(1, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(1, cfg.vocab_size, (3, B)).astype(np.int32)
    return rcfg, cfg, rmodel, rparams, params, images, tokens, steps


def _inputs(dtype: str):
    jdt, tdt, _ = DTYPES[dtype]
    *_, images, tokens, _ = _setup(dtype)
    return ({"tokens": jnp.asarray(tokens),
             "extra_embeds": jnp.asarray(images, jdt)},
            {"tokens": torch.from_numpy(tokens).long(),
             "extra_embeds": torch.from_numpy(images).to(tdt)})


def test_config_is_registered_and_matches_the_reference():
    for smoke in (False, True):
        ours = dataclasses.asdict(get_config(ARCH, smoke=smoke))
        theirs = dataclasses.asdict(ref_config(ARCH, smoke=smoke))
        assert ours.pop("dtype") == torch.bfloat16
        theirs.pop("dtype")
        assert ours == theirs
    full = get_config(ARCH)
    assert (full.family, full.n_layers, full.d_model, full.n_heads,
            full.n_kv_heads, full.head_dim, full.d_ff, full.vocab_size,
            full.frontend.n_tokens, full.frontend.feat_dim) == (
        "vlm", 32, 4096, 32, 8, 128, 14336, 32000, 2880, 1024)


def test_model_init_matches_the_reference_tree():
    """``Model.init`` draws the reference's tree (the ``frontend``
    projector: two linears with biases) with its shapes and dtypes."""
    _, cfg, _, _, params, *_ = _setup("bfloat16")
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

    walk(ours, params)
    fe = cfg.frontend
    assert tuple(ours["frontend"]["proj1"]["w"].shape) == (fe.feat_dim,
                                                            cfg.d_model)
    assert tuple(ours["frontend"]["proj2"]["b"].shape) == (cfg.d_model,)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_with_images_and_decode_match_reference(dtype, use_kernels):
    """The image rows first, then the prompt: last-token logits and K/V of
    all S' = 8 + 7 positions (cache 24), then 3 decode steps from position S'."""
    tol = DTYPES[dtype][2]
    rcfg, cfg, rmodel, rparams, params, images, _, steps = _setup(dtype)
    r_in, t_in = _inputs(dtype)
    r_logits, r_caches = rmodel.prefill(rparams, r_in, cache_len=CACHE)
    model = Model(cfg, use_kernels=use_kernels)
    logits, caches = model.prefill(params, t_in, cache_len=CACHE)
    assert logits.dtype == torch.float32
    _close(logits, r_logits, tol)
    s = images.shape[1] + PROMPT
    for (rk, rv), (k, v) in zip(r_caches, caches):
        assert tuple(k.shape) == rk.shape == (cfg.n_layers, B, CACHE,
                                              cfg.n_kv_heads, cfg.head_dim)
        _close(k, rk, tol)
        _close(v, rv, tol)
        assert not bool(k[:, :, s:].any())
    for i, tok in enumerate(steps):
        pos = np.full((B,), s + i, np.int32)
        r_logits, r_caches = rmodel.decode(rparams, jnp.asarray(tok),
                                           r_caches, jnp.asarray(pos))
        logits, caches = model.decode(params, torch.from_numpy(tok).long(),
                                      caches, torch.from_numpy(pos))
        _close(logits, r_logits, tol)
    for (rk, rv), (k, v) in zip(r_caches, caches):
        _close(k, rk, tol)
        _close(v, rv, tol)


def test_images_change_the_logits_and_text_only_prefill_matches():
    """The projector's rows move the logits (they are attended), and a
    text-only prefill of the vlm config is the reference's text-only one."""
    rcfg, cfg, rmodel, rparams, params, *_ = _setup("float32")
    r_in, t_in = _inputs("float32")
    with_images = Model(cfg).prefill(params, t_in)[0]
    text = {"tokens": t_in["tokens"]}
    text_only = Model(cfg).prefill(params, text)[0]
    assert float((with_images - text_only).abs().max()) > 1e-3
    _close(text_only, rmodel.prefill(rparams, {"tokens": r_in["tokens"]})[0],
           1e-5)


def test_bf16_images_with_fp32_embeddings_promote_as_the_reference():
    """fp32 patch embeddings into a bf16 model: the projector runs in fp32
    (the reference's einsums promote), its rows cast to bf16."""
    rcfg, cfg, rmodel, rparams, params, images, tokens, _ = _setup("bfloat16")
    want = rmodel.prefill(rparams, {"tokens": jnp.asarray(tokens),
                                    "extra_embeds": jnp.asarray(images)})[0]
    got = Model(cfg).prefill(params, {
        "tokens": torch.from_numpy(tokens).long(),
        "extra_embeds": torch.from_numpy(images)})[0]
    _close(got, want, DTYPES["bfloat16"][2])


# -- the op graph ------------------------------------------------------------------------

def _steps(exe):
    return [(s.route, tuple(s.op_ids), tuple(s.group_sizes),
             tuple(s.free_slots), tuple(s.out_slots), tuple(s.arg_slots))
            for s in exe.steps]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_op_graph_matches_reference(dtype, tmp_path):
    """The text-only export (no frontend nodes, C13): 44 nodes at batch 1,
    seq 16 with params, node for node, equal digests, steps and program
    stats; its
    output against the reference's program and the port's text-only
    ``lm_forward`` without RoPE (the export applies none, C5)."""
    tol = DTYPES[dtype][2]
    rcfg, cfg, _, rparams, params, *_ = _setup(dtype)
    rg = ref_export(rcfg, batch=1, seq=16, params=rparams)
    pg = build_lm_opgraph(cfg, batch=1, seq=16, params=params)
    assert len(pg) == len(rg) == 44
    assert [n.name for n in pg] == [n.name for n in rg]
    assert [n.kind.value for n in pg] == [n.kind.value for n in rg]
    assert not any("frontend" in n.name for n in pg)
    assert pg.node_signature() == rg.node_signature()
    rexe = ref_compile(ref_schedule(rg, "opara", "opara"),
                       gemm_kernel="pallas")
    pexe = compile_plan(schedule(pg, "opara", "opara"), gemm_kernel="kernel")
    assert _steps(pexe) == _steps(rexe)
    assert pexe.program_stats() == rexe.program_stats()
    sess = Session(SessionConfig(device="cpu", hw=V5E,
                                 calib_dir=str(tmp_path)))
    tok = np.random.default_rng(5).integers(0, rcfg.vocab_size,
                                            (1, 16)).astype(np.int32)
    model = sess.compile(pg, inputs={0: torch.from_numpy(tok).long()})
    got = model({"tokens": torch.from_numpy(tok)})[-1]
    _close(got, rexe({"tokens": jnp.asarray(tok)})[-1], tol)
    want, _ = lm_forward(params, torch.from_numpy(tok).long(),
                         dataclasses.replace(cfg, rope=False),
                         with_cache=False)
    _close(got, want, tol)


@pytest.mark.parametrize("smoke, seq, n_nodes", [(True, 16, 50),
                                                 (False, 64, None)],
                         ids=["smoke", "full-width"])
def test_cost_only_export_matches_reference(smoke, seq, n_nodes):
    """Cost-only (no params: the FF weights stream as DMA nodes), at the
    smoke config (50 nodes) and at full width over 2 layers."""
    rg = ref_export(ref_config(ARCH, smoke=smoke), batch=1, seq=seq,
                    n_layers=2)
    pg = build_lm_opgraph(get_config(ARCH, smoke=smoke), batch=1, seq=seq,
                          n_layers=2)
    assert n_nodes is None or len(pg) == n_nodes
    assert [n.name for n in pg] == [n.name for n in rg]
    assert pg.node_signature() == rg.node_signature()


# -- serving -----------------------------------------------------------------------------

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
    _, cfg, rmodel, rparams, params, *_ = _setup("float32")
    trace = build_trace(n=12, seed=7)
    kw = dict(max_slots=2, max_len=64, seed=3, paged_kv=paged, page_size=16)
    ref = RefEngine(rmodel, rparams,
                    admission=RefAdmission(policy="edf", preemption=True),
                    **kw)
    port = InferenceEngine(Model(cfg, use_kernels=use_kernels), params,
                           admission=AdmissionConfig(policy="edf",
                                                     preemption=True), **kw)
    return ((ref, _terminal_map(ref_drive(ref, trace))),
            (port, _terminal_map(_drive(port, trace))))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_matches_reference_on_overload_trace(paged):
    (ref, ref_done), (port, port_done) = _served(paged)
    assert port.paged is paged and ref.paged is paged
    assert port_done == ref_done
    assert port.tick == ref.tick


def test_engine_paged_equals_dense_and_kernel_route_equals_plain():
    dense = _served(False)[1][1]
    assert _served(True)[1][1] == dense
    assert _served(True, True)[1][1] == dense


def test_serve_cli_runs_the_llava_smoke_config_on_the_cpu():
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-tokens", "4", "--calibrate"]) == 0
