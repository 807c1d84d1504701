"""The port's encoder-decoder family (Whisper) against the JAX package's.

Held on numpy-seeded inputs and on params drawn by the JAX ``init`` and
converted bit-exactly by ``repro_torch.bridge``, at the whisper-medium
smoke config (2 encoder + 2 decoder layers, d 64, 4 heads of 16, 16
frames of 24 features):

* ``layernorm`` and the tanh ``gelu`` against ``repro.models.layers``;
* the init tree (keys, shapes, dtypes) against ``init_encdec``'s;
* ``encode``, ``decode_seq`` and ``Model.prefill`` (logits and both
  caches, the self K/V padded to the cache length) and greedy
  ``Model.decode`` steps, the port's plain route and its kernel route
  against the reference's routes of the same name (on the CPU the
  reference's kernel route runs its flash reference and its Pallas decode
  kernel in interpret mode; the cache length 128 puts the decode on its
  tile lattice); fp32 decodes the same greedy tokens;
* ``encdec_decode``'s one learned position for the whole batch (ROADMAP
  C15), reproduced;
* the op graph node for node (names, kinds, ``fuse_sig``s, declared
  shapes, ``node_signature()`` digests), its lowered steps and
  ``program_stats()``, and the captured executable against the reference's
  on the same inputs and against eager per-op execution; no fused step
  mixes encoder and decoder rows;
* the full-width graph's schedule statistics (2 layers) against the
  reference's.

Tolerances: fp32 1e-5 elementwise; bf16 2e-2 relative L2 over the tensor,
the JAX package's bf16 differential tolerance.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.scheduler import compile_plan as ref_compile  # noqa: E402
from repro.core.scheduler import schedule as ref_schedule  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models import encdec as ref_ed  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.opgraph_export import build_encdec_opgraph as ref_export  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import V5E, Session, SessionConfig  # noqa: E402
from repro_torch.core.capture import run_sequential_uncompiled  # noqa: E402
from repro_torch.core.scheduler import compile_plan, schedule  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import encdec, layers  # noqa: E402
from repro_torch.models.opgraph_export import (build_encdec_opgraph,  # noqa: E402
                                               build_lm_opgraph)
from repro_torch.models.transformer import init_lm  # noqa: E402

ARCH = "whisper-medium"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, PROMPT, CACHE, STEPS = 2, 5, 128, 4


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
    rparams = RefModel(rcfg).init(jax.random.key(0))
    params = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                               "cpu")
    rng = np.random.default_rng(7)
    fe = rcfg.frontend
    frames = rng.standard_normal((B, fe.n_tokens, fe.feat_dim)).astype(
        np.float32)
    tokens = rng.integers(1, rcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return rcfg, cfg, rparams, params, frames, tokens


def _inputs(dtype: str):
    jdt, tdt, _ = DTYPES[dtype]
    *_, frames, tokens = _setup(dtype)
    return ({"frames": jnp.asarray(frames, jdt),
             "tokens": jnp.asarray(tokens)},
            {"frames": torch.from_numpy(frames).to(tdt),
             "tokens": torch.from_numpy(tokens).long()})


# -- configs and primitives -------------------------------------------------------

def test_config_is_registered_and_matches_the_reference():
    for smoke in (False, True):
        ours = dataclasses.asdict(get_config(ARCH, smoke=smoke))
        theirs = dataclasses.asdict(ref_config(ARCH, smoke=smoke))
        assert ours.pop("dtype") == torch.bfloat16
        theirs.pop("dtype")
        assert ours == theirs
    full = get_config(ARCH)
    assert (full.family, full.n_layers, full.n_dec_layers, full.d_model,
            full.n_heads, full.head_dim, full.d_ff, full.vocab_size,
            full.frontend.n_tokens) == ("encdec", 24, 24, 1024, 16, 64, 4096,
                                        51865, 1500)
    # every architecture of the JAX package is registered, llava the last
    assert get_config("llava-next-mistral-7b").family == "vlm"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llava-next")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layernorm_matches_reference(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, 48)) * 4 + 1).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    want = ref_layers.layernorm({"scale": jnp.asarray(scale, jdt),
                                 "bias": jnp.asarray(bias, jdt)},
                                jnp.asarray(x, jdt))
    p = layers.init_norm(48, "layernorm", tdt, device="cpu")
    assert sorted(p) == ["bias", "scale"] and p["bias"].dtype == tdt
    p["scale"].copy_(torch.from_numpy(scale))
    p["bias"].copy_(torch.from_numpy(bias))
    got = layers.layernorm(p, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    _close(got, want, tol)
    _close(layers.apply_norm(p, torch.from_numpy(x).to(tdt), "layernorm"),
           want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gelu_is_the_reference_tanh_form(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x = np.linspace(-6, 6, 301, dtype=np.float32)
    got = layers.gelu(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    _close(got, ref_layers.gelu(jnp.asarray(x, jdt)), tol)
    # the tanh form, not the erf one: they differ by more than fp32 noise
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((layers.gelu(torch.from_numpy(x)) - exact).abs().max()) > 1e-4


# -- the model facade ---------------------------------------------------------------

def test_init_matches_the_reference_tree():
    _, cfg, _, params, _, _ = _setup("bfloat16")
    ours = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")

    def walk(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                walk(a[k], b[k])
        else:
            assert a.shape == b.shape and a.dtype == b.dtype

    walk(ours, params)
    assert tuple(ours["dec_blocks"]["cross_attn"]["wk"]["w"].shape) == (
        cfg.n_dec_layers, cfg.d_model, cfg.d_model)
    assert float(ours["frontend_proj"]["b"].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encode_matches_reference(dtype):
    tol = DTYPES[dtype][2]
    rcfg, cfg, rparams, params, _, _ = _setup(dtype)
    rin, tin = _inputs(dtype)
    want = ref_ed.encode(rparams, rin["frames"], rcfg)
    got = encdec.encode(params, tin["frames"], cfg)
    assert got.dtype == cfg.dtype
    _close(got, want, tol)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_seq_matches_reference(dtype, use_kernels):
    tol = DTYPES[dtype][2]
    rcfg, cfg, rparams, params, _, _ = _setup(dtype)
    rin, tin = _inputs(dtype)
    # the same encoder output on both sides: the decoder alone is held here
    enc = encdec.encode(params, tin["frames"], cfg)
    r_logits, r_caches = ref_ed.decode_seq(
        rparams, rin["tokens"], jnp.asarray(_np(enc), rcfg.dtype), rcfg,
        use_kernels=use_kernels)
    logits, caches = encdec.decode_seq(params, tin["tokens"], enc, cfg,
                                       use_kernels)
    assert logits.dtype == torch.float32
    _close(logits, r_logits, tol)
    for got, want in zip(jax.tree_util.tree_leaves(caches),
                         jax.tree_util.tree_leaves(r_caches)):
        _close(got, want, tol)


def _prefill(dtype: str, use_kernels: bool):
    rcfg, cfg, rparams, params, _, _ = _setup(dtype)
    rin, tin = _inputs(dtype)
    rmodel, model = RefModel(rcfg, use_kernels), Model(cfg, use_kernels)
    r_out = rmodel.prefill(rparams, rin, cache_len=CACHE)
    return rmodel, model, r_out, model.prefill(params, tin, cache_len=CACHE)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_logits_and_both_caches_match_reference(dtype, use_kernels):
    tol = DTYPES[dtype][2]
    _, cfg, *_ = _setup(dtype)
    _, _, (r_logits, r_caches), (logits, caches) = _prefill(dtype,
                                                             use_kernels)
    _close(logits, r_logits, tol)
    (k, v), (ck, cv) = caches
    assert tuple(k.shape) == (cfg.n_dec_layers, B, CACHE, cfg.n_kv_heads,
                              cfg.head_dim)
    assert tuple(ck.shape) == (cfg.n_dec_layers, B, cfg.frontend.n_tokens,
                               cfg.n_kv_heads, cfg.head_dim)
    assert float(k[:, :, PROMPT:].abs().max()) == 0.0   # zero padding
    (rk, rv), (rck, rcv) = r_caches
    for got, want in ((k, rk), (v, rv), (ck, rck), (cv, rcv)):
        _close(got, want, tol)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_greedy_decode_steps_match_reference(dtype, use_kernels):
    """Greedy decoding from the prefill: each step's logits held against
    the reference's (the reference's greedy token fed to both sides); in
    fp32 the port picks the same tokens."""
    tol = DTYPES[dtype][2]
    _, _, rparams, params, _, _ = _setup(dtype)
    rmodel, model, (r_logits, r_caches), (logits, caches) = _prefill(
        dtype, use_kernels)
    ptrs = [t.data_ptr() for t in jax.tree_util.tree_leaves(caches)]
    tok = np.array(jnp.argmax(r_logits, -1), np.int32)
    for i in range(STEPS):
        pos = np.full((B,), PROMPT + i, np.int32)
        r_logits, r_caches = rmodel.decode(rparams, jnp.asarray(tok),
                                           r_caches, jnp.asarray(pos))
        logits, caches = model.decode(params, torch.from_numpy(tok).long(),
                                      caches, torch.from_numpy(pos))
        _close(logits, r_logits, tol)
        tok = np.array(jnp.argmax(r_logits, -1), np.int32)
        if dtype == "float32":
            assert (logits.argmax(-1).numpy() == tok).all()
    # the self K/V written in place; the cross K/V untouched
    assert ptrs == [t.data_ptr() for t in jax.tree_util.tree_leaves(caches)]
    for got, want in zip(jax.tree_util.tree_leaves(caches),
                         jax.tree_util.tree_leaves(r_caches)):
        _close(got, want, tol)


def test_decode_gives_every_row_the_first_rows_position():
    """ROADMAP C15: ``encdec_decode`` adds ``dec_pos[pos[0]]`` to every row.
    With rows at unequal positions the port agrees with the reference, and
    a row alone at its own position gives other logits."""
    tol = DTYPES["float32"][2]
    _, _, (_, r_caches), (_, caches) = _prefill("float32", False)
    rcfg, cfg, rparams, params, _, tokens = _setup("float32")
    tok = tokens[:, -1]
    pos = np.array([PROMPT, PROMPT + 3], np.int32)
    r_logits, _ = RefModel(rcfg).decode(rparams, jnp.asarray(tok), r_caches,
                                        jnp.asarray(pos))
    kept = [t.clone() for t in jax.tree_util.tree_leaves(caches)]
    logits, _ = Model(cfg).decode(params, torch.from_numpy(tok).long(),
                                  caches, torch.from_numpy(pos))
    _close(logits, r_logits, tol)
    for leaf, k in zip(jax.tree_util.tree_leaves(caches), kept):
        leaf.copy_(k)
    alone, _ = Model(cfg).decode(
        params, torch.from_numpy(tok[1:]).long(),
        jax.tree_util.tree_map(lambda t: t[:, 1:], caches),
        torch.from_numpy(pos[1:]))
    assert float((alone[0] - logits[1]).abs().max()) > 1e-4


def test_the_lm_paths_refuse_the_encoder_decoder():
    _, cfg, _, params, frames, tokens = _setup("float32")
    model = Model(cfg)
    assert not model.supports_paged()
    # the facade's loss is the encoder-decoder's own; the LM loss refuses
    batch = {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(tokens).long(),
             "labels": torch.from_numpy(tokens).long()}
    loss, metrics = model.loss(params, batch)
    assert set(metrics) == {"ce"} and bool(torch.isfinite(loss))
    from repro_torch.models.transformer import lm_loss
    with pytest.raises(NotImplementedError, match="models/encdec.py"):
        lm_loss(params, batch, cfg)
    with pytest.raises(NotImplementedError, match="models/encdec.py"):
        init_lm(cfg, torch.Generator(), "cpu")
    with pytest.raises(NotImplementedError, match="build_encdec_opgraph"):
        build_lm_opgraph(cfg, 1, 4)
    # the serving engine serves decoder LMs, as the reference's does
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.serve(ARCH, 1, 1, device="cpu")


# -- the op graph ------------------------------------------------------------------------

def _steps(exe):
    return [(s.route, tuple(s.op_ids), tuple(s.group_sizes),
             tuple(s.free_slots), tuple(s.out_slots), tuple(s.arg_slots))
            for s in exe.steps]


def _same_nodes(pg, rg):
    assert [n.name for n in pg] == [n.name for n in rg]
    assert [n.kind.value for n in pg] == [n.kind.value for n in rg]
    assert [n.inputs for n in pg] == [n.inputs for n in rg]
    assert [n.fuse_sig for n in pg] == [n.fuse_sig for n in rg]
    assert [n.out_shape for n in pg] == [n.out_shape for n in rg]
    assert pg.node_signature() == rg.node_signature()
    assert pg.signature_digest() == rg.signature_digest()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_op_graph_matches_reference(dtype, tmp_path):
    tol = DTYPES[dtype][2]
    rcfg, cfg, rparams, params, _, _ = _setup(dtype)
    rg = ref_export(rcfg, batch=B, dec_seq=PROMPT, params=rparams)
    pg = build_encdec_opgraph(cfg, batch=B, dec_seq=PROMPT, params=params)
    _same_nodes(pg, rg)
    assert [n.name for n in pg if n.fn is None] == ["frames", "tokens"]
    rexe = ref_compile(ref_schedule(rg, "opara", "opara"),
                       gemm_kernel="pallas")
    pexe = compile_plan(schedule(pg, "opara", "opara"), gemm_kernel="kernel")
    assert _steps(pexe) == _steps(rexe)
    assert pexe.program_stats() == rexe.program_stats()
    # no fused step stacks branches of unequal declared input shapes (the
    # encoder's frames against the decoder's tokens)
    for step in pexe.steps:
        if len(step.op_ids) > 1:
            shapes = {pg.nodes[pg.nodes[o].inputs[0]].out_shape
                      for o in step.op_ids}
            assert len(shapes) == 1 or step.group_sizes, step.op_ids
    sess = Session(SessionConfig(device="cpu", hw=V5E,
                                 calib_dir=str(tmp_path)))
    rin, tin = _inputs(dtype)
    ids = {n.name: n.op_id for n in pg if n.fn is None}
    model = sess.compile(pg, inputs={ids[k]: v for k, v in tin.items()})
    assert model.executable.program_stats()["n_branch_gemm"] >= 1
    got = model(tin)
    want = rexe(rin)
    _close(got[-1], want[-1], tol)
    seq = run_sequential_uncompiled(pg, tin, model.executable.output_ids)
    _close(got[-1], seq[-1], tol)


def test_differential_whisper_encdec():
    """``test_differential_whisper_encdec`` of the JAX package, ported: the
    fp32 export with real payloads through the whole pipeline against
    eager per-op execution, and against the reference's executable on the
    same inputs."""
    rcfg, cfg, rparams, params, _, _ = _setup("float32")
    g = build_encdec_opgraph(cfg, 1, 4, params=params, n_layers=2)
    assert any(n.name.endswith(".cross_softmax") for n in g)
    rng = np.random.default_rng(7)
    frames = rng.standard_normal(
        (1, cfg.frontend.n_tokens, cfg.frontend.feat_dim)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (1, 4)).astype(np.int32)
    inputs = {"frames": torch.from_numpy(frames),
              "tokens": torch.from_numpy(tokens).long()}
    exe = Session(device="cpu", hw=V5E).optimize(g)
    ref = run_sequential_uncompiled(g, inputs, output_ids=exe.output_ids)
    got = exe(inputs)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _close(a, b, 1e-5)
    rg = ref_export(rcfg, 1, 4, n_layers=2, params=rparams)
    rexe = ref_compile(ref_schedule(rg, "opara", "opara"),
                       gemm_kernel="pallas")
    want = rexe({"frames": jnp.asarray(frames),
                 "tokens": jnp.asarray(tokens)})
    _close(got[-1], want[-1], 1e-5)


def test_full_width_graph_schedules_as_the_reference():
    """``test_encdec_opgraph_exports_and_schedules`` of the JAX package,
    ported: the cost-only full-width graph at 2 layers, node for node, and
    its plan's statistics equal to the reference's."""
    rg = ref_export(ref_config(ARCH), batch=1, dec_seq=64, n_layers=2)
    pg = build_encdec_opgraph(get_config(ARCH), batch=1, dec_seq=64,
                              n_layers=2)
    _same_nodes(pg, rg)
    stats = schedule(pg, "opara", "opara").stats()

    def structural(st):     # the stage timings are wall-clock
        return {k: v for k, v in st.items() if not k.endswith("_ms")}

    assert structural(stats) == structural(
        ref_schedule(rg, "opara", "opara").stats())
    assert structural(stats).keys() >= {"n_streams", "n_ops",
                                        "n_kernels_after_fusion"}
    # encoder chain ∥ decoder embedding + cross-KV branches → several lanes
    assert stats["n_streams"] >= 4
    assert stats["n_kernels_after_fusion"] < stats["n_ops"]


def test_cross_kv_projections_read_only_the_encoder_output():
    """The fan-out the paper's T5 case highlights: every decoder layer's
    cross K/V GEMMs read the encoder output and nothing of the decoder."""
    cfg = get_config(ARCH)
    g = build_encdec_opgraph(cfg, batch=1, dec_seq=224, n_layers=3)
    enc_out = next(n.op_id for n in g if n.name == "enc_norm")
    cross = [n for n in g if n.name.endswith((".cross_wk", ".cross_wv"))]
    assert len(cross) == 2 * 3
    assert all(n.inputs == (enc_out,) or list(n.inputs) == [enc_out]
               for n in cross)
    assert all(n.cost.flops == 2 * 1500 * cfg.d_model * cfg.d_model
               for n in cross)


def test_mixed_encoder_decoder_groups_run_as_single_gemms():
    """ROADMAP C16: the plan puts the first encoder layer's and the first
    decoder layer's q/k/v (and wo) GEMMs in one fusion group; their
    declared inputs differ in rows, so capture neither stacks them nor
    takes the grouped ragged-M route (which needs 2-D declared inputs):
    each runs as a single GEMM, in both packages."""
    rcfg, cfg, rparams, params, _, _ = _setup("float32")
    pg = build_encdec_opgraph(cfg, batch=B, dec_seq=PROMPT, params=params)
    plan = schedule(pg, "opara", "opara")
    mixed = [grp for w in plan.waves.waves for grp in w.fusion_groups
             if len(grp) > 1 and len({pg.nodes[pg.nodes[o].inputs[0]].out_shape
                                      for o in grp}) > 1]
    names = sorted(pg.nodes[o].name for grp in mixed for o in grp)
    assert names == ["d0.wk", "d0.wo", "d0.wq", "d0.wv",
                     "e0.wk", "e0.wo", "e0.wq", "e0.wv"]
    rexe = ref_compile(ref_schedule(
        ref_export(rcfg, batch=B, dec_seq=PROMPT, params=rparams),
        "opara", "opara"), gemm_kernel="pallas")
    for exe in (compile_plan(plan, gemm_kernel="kernel"), rexe):
        routes = {pg.nodes[o].name: (s.route, len(s.op_ids))
                  for s in exe.steps for o in s.op_ids}
        assert {routes[n] for n in names} == {("call", 1)}
