"""The port's three dense archs beyond Qwen2 — llama3.2-1b (tied head,
GQA 32/8), minicpm-2b (MHA, depth-scaled residuals) and glm4-9b (QKV bias,
GQA 32/2) — against the JAX package's, on their smoke configs.

Params come from the JAX ``init`` and are converted bit-exactly by
``repro_torch.bridge``; tokens come from numpy.  Per arch, each a case of
one parametrised test:

* the Model facade's prefill, 3 dense decode steps and 3 paged decode
  steps, the port on its plain route and its kernel route (whose wrappers
  run their plain versions on CPU tensors), the reference on its plain
  route; the whole forward's logits at every position against the
  reference's ``lm_forward``;
* the op graph node for node against ``build_lm_opgraph`` of the JAX
  package (names, kinds, ``fuse_sig``s, lowered steps, ``program_stats()``)
  and its executed output against the JAX package's captured program; the
  full-width cost-only graphs are equal too.  minicpm's export adds its
  residuals without ``residual_scale``, as the reference's does (ROADMAP
  C13): the graph is held against the reference's graph and the facade
  against ``lm_forward``.

Tolerances: fp32 1e-5; bf16 2e-2 relative L2 over the tensor, the JAX
package's bf16 differential tolerance.
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
from repro.models.opgraph_export import build_lm_opgraph as ref_export  # noqa: E402
from repro.models.transformer import lm_forward as ref_lm_forward  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import V5E, Session, SessionConfig  # noqa: E402
from repro_torch.core.scheduler import compile_plan, schedule  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.opgraph_export import build_lm_opgraph  # noqa: E402

ARCHS = ("llama3.2-1b", "minicpm-2b", "glm4-9b")
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, PROMPT, CACHE, PAGE = 2, 11, 24, 4


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
def _setup(arch: str, dtype: str):
    jdt, tdt, _ = DTYPES[dtype]
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype=jdt)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=tdt)
    rmodel = RefModel(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    params = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                               "cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, rcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(1, rcfg.vocab_size, (3, B)).astype(np.int32)
    return rcfg, cfg, rmodel, rparams, params, tokens, steps


def _prefill(arch, dtype, use_kernels):
    rcfg, cfg, rmodel, rparams, params, tokens, steps = _setup(arch, dtype)
    r_logits, r_caches = rmodel.prefill(rparams,
                                        {"tokens": jnp.asarray(tokens)},
                                        cache_len=CACHE)
    model = Model(cfg, use_kernels=use_kernels)
    logits, caches = model.prefill(
        params, {"tokens": torch.from_numpy(tokens).long()}, cache_len=CACHE)
    return (rmodel, rparams, r_logits, r_caches), (model, params, logits,
                                                   caches), steps


def test_configs_match_the_reference():
    for arch in ARCHS:
        for smoke in (False, True):
            ours = dataclasses.asdict(get_config(arch, smoke=smoke))
            theirs = dataclasses.asdict(ref_config(arch, smoke=smoke))
            assert ours.pop("dtype") == torch.bfloat16
            theirs.pop("dtype")
            assert ours == theirs


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype, use_kernels):
    tol = DTYPES[dtype][2]
    (_, _, r_logits, r_caches), (_, _, logits, caches), _ = _prefill(
        arch, dtype, use_kernels)
    assert logits.dtype == torch.float32
    _close(logits, r_logits, tol)
    for (rk, rv), (k, v) in zip(r_caches, caches):
        assert tuple(k.shape) == rk.shape
        _close(k, rk, tol)
        _close(v, rv, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_reference_at_every_position(arch):
    """The facade's forward (MiniCPM's scaled residuals included) against
    the reference's ``lm_forward``, every position's logits, fp32."""
    from repro_torch.models.transformer import lm_forward
    rcfg, cfg, _, rparams, params, tokens, _ = _setup(arch, "float32")
    want, _, _ = ref_lm_forward(rparams, jnp.asarray(tokens), rcfg)
    for use_kernels in (False, True):
        got, _ = lm_forward(params, torch.from_numpy(tokens).long(), cfg,
                            use_kernels, with_cache=False)
        _close(got, want, DTYPES["float32"][2])


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dtype, use_kernels):
    tol = DTYPES[dtype][2]
    (rmodel, rparams, _, r_caches), (model, params, _, caches), steps = \
        _prefill(arch, dtype, use_kernels)
    for i, tok in enumerate(steps):
        pos = np.full((B,), PROMPT + i, np.int32)
        r_logits, r_caches = rmodel.decode(rparams, jnp.asarray(tok),
                                           r_caches, jnp.asarray(pos))
        logits, caches = model.decode(params, torch.from_numpy(tok).long(),
                                      caches, torch.from_numpy(pos))
        _close(logits, r_logits, tol)
    for (rk, rv), (k, v) in zip(r_caches, caches):
        _close(k, rk, tol)
        _close(v, rv, tol)


def _to_pages(dense_leaf, tables, num_pages):
    """[L,B,T,...] dense cache → [L,P,PAGE,...] pages via the block tables."""
    leaf = _np(dense_leaf)
    pages = np.zeros((leaf.shape[0], num_pages, PAGE) + leaf.shape[3:],
                     np.float32)
    for b, table in enumerate(tables):
        for i, page in enumerate(table):
            pages[:, page] = leaf[:, b, i * PAGE:(i + 1) * PAGE]
    return pages


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_reference(arch, dtype, use_kernels):
    """Both sides start from the same pages (the reference's prefill caches
    scattered through a shuffled block table) and take 3 paged steps."""
    jdt, tdt, tol = DTYPES[dtype]
    (rmodel, rparams, _, r_caches), (model, params, _, _), steps = _prefill(
        arch, dtype, use_kernels)
    assert model.supports_paged()
    maxp = CACHE // PAGE
    num_pages = 1 + B * maxp
    order = np.random.default_rng(3).permutation(np.arange(1, num_pages))
    tables = order.reshape(B, maxp).astype(np.int32)
    r_pages = [tuple(jnp.asarray(_to_pages(x, tables, num_pages), jdt)
                     for x in kv) for kv in r_caches]
    pages = [tuple(torch.from_numpy(_to_pages(x, tables, num_pages)).to(tdt)
                   for x in kv) for kv in r_caches]
    bt_r, bt = jnp.asarray(tables), torch.from_numpy(tables)
    for i, tok in enumerate(steps):
        pos = np.full((B,), PROMPT + i, np.int32)
        r_logits, r_pages = rmodel.paged_decode(rparams, jnp.asarray(tok),
                                                r_pages, bt_r,
                                                jnp.asarray(pos))
        logits, pages = model.paged_decode(
            params, torch.from_numpy(tok).long(), pages, bt,
            torch.from_numpy(pos))
        _close(logits, r_logits, tol)
    for (rk, rv), (k, v) in zip(r_pages, pages):
        _close(k, rk, tol)
        _close(v, rv, tol)


# -- the op graph ------------------------------------------------------------------------

def _steps(exe):
    return [(s.route, tuple(s.op_ids), tuple(s.group_sizes),
             tuple(s.free_slots), tuple(s.out_slots), tuple(s.arg_slots))
            for s in exe.steps]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_op_graph_matches_reference(arch, dtype, tmp_path):
    tol = DTYPES[dtype][2]
    rcfg, cfg, _, rparams, params, _, _ = _setup(arch, dtype)
    rg = ref_export(rcfg, batch=2, seq=8, params=rparams)
    pg = build_lm_opgraph(cfg, batch=2, seq=8, params=params)
    assert [n.name for n in pg] == [n.name for n in rg]
    assert [n.kind.value for n in pg] == [n.kind.value for n in rg]
    assert [n.fuse_sig for n in pg] == [n.fuse_sig for n in rg]
    assert pg.node_signature() == rg.node_signature()
    rexe = ref_compile(ref_schedule(rg, "opara", "opara"),
                       gemm_kernel="pallas")
    pexe = compile_plan(schedule(pg, "opara", "opara"), gemm_kernel="kernel")
    assert _steps(pexe) == _steps(rexe)
    assert pexe.program_stats() == rexe.program_stats()
    assert pexe.program_stats()["n_branch_gemm"] >= 2 * cfg.n_layers
    sess = Session(SessionConfig(device="cpu", hw=V5E,
                                 calib_dir=str(tmp_path)))
    tok = np.random.default_rng(5).integers(0, rcfg.vocab_size,
                                            (2, 8)).astype(np.int32)
    model = sess.compile(pg, inputs={0: torch.from_numpy(tok).long()})
    got = model({"tokens": torch.from_numpy(tok)})
    want = rexe({"tokens": jnp.asarray(tok)})
    _close(got[-1], want[-1], tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_cost_only_export_matches_reference_at_full_width(arch):
    rg = ref_export(ref_config(arch), batch=1, seq=64, n_layers=2)
    pg = build_lm_opgraph(get_config(arch), batch=1, seq=64, n_layers=2)
    assert [n.name for n in pg] == [n.name for n in rg]
    assert pg.node_signature() == rg.node_signature()


def test_minicpm_export_adds_residuals_without_the_scale():
    """ROADMAP C13: the exported graph ignores ``residual_scale`` (its
    output is the same with the scale set to 1), while the facade scales
    both residuals (its logits move with the scale, by far more than fp32
    rounding)."""
    rcfg, cfg, _, rparams, params, _, _ = _setup("minicpm-2b", "float32")
    assert cfg.residual_scale == pytest.approx(1.4 / 2 ** 0.5)
    unscaled = dataclasses.replace(cfg, residual_scale=1.0)
    tok = np.random.default_rng(5).integers(0, rcfg.vocab_size,
                                            (1, 8)).astype(np.int32)

    def graph(c):
        exe = compile_plan(schedule(
            build_lm_opgraph(c, batch=1, seq=8, params=params), "opara",
            "opara"), gemm_kernel="kernel")
        return exe({"tokens": torch.from_numpy(tok)})[-1]

    def facade(c):
        return Model(c).prefill(params,
                                {"tokens": torch.from_numpy(tok).long()})[0]

    assert torch.equal(graph(cfg), graph(unscaled))
    assert float((facade(cfg) - facade(unscaled)).abs().max()) > 1e-5
