"""The port's Model facade against the JAX package's on qwen2-0.5b smoke.

Params come from the JAX ``init`` and are converted bit-exactly by
``repro_torch.bridge``; tokens come from numpy.  Both sides run prefill, 3
dense decode steps and 3 paged decode steps, the reference on its plain
path (``use_kernels=False``), the port on its plain path and on its kernel
route (whose wrappers run their plain versions on CPU tensors).

Tolerances: fp32 1e-5 elementwise (the same arithmetic in another
summation order); bf16 2e-2 relative L2 over the tensor, the JAX package's
bf16 differential tolerance and the measure ``chip_smoke.py`` applies on the
card (the two frameworks round bf16 intermediates at different places, e.g.
inside silu, and the kernel route's flash plain version keeps probabilities
in fp32, so single elements drift by an ulp or two and a near-zero one can
be off by more than 2e-2 of itself).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, PROMPT, CACHE, PAGE = 2, 11, 24, 4


@functools.lru_cache(maxsize=None)
def _setup(dtype: str, window: int | None = None):
    jdt, tdt, _ = DTYPES[dtype]
    over = {} if window is None else {"window": window}
    jcfg = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True),
                               dtype=jdt, **over)
    tcfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                               dtype=tdt, **over)
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.key(0))
    tparams = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                "cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(1, jcfg.vocab_size, (3, B)).astype(np.int32)
    return jcfg, tcfg, jmodel, params, tparams, tokens, steps


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


def _prefill(dtype, use_kernels, window=None):
    jcfg, tcfg, jmodel, params, tparams, tokens, steps = _setup(dtype, window)
    j_logits, j_caches = jmodel.prefill(params, {"tokens": jnp.asarray(tokens)},
                                        cache_len=CACHE)
    model = Model(tcfg, use_kernels=use_kernels)
    t_logits, t_caches = model.prefill(
        tparams, {"tokens": torch.from_numpy(tokens).long()}, cache_len=CACHE)
    return (jmodel, params, j_logits, j_caches), (model, tparams, t_logits,
                                                  t_caches), steps


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_logits_and_caches_match_reference(dtype, use_kernels):
    tol = DTYPES[dtype][2]
    (_, _, j_logits, j_caches), (_, _, t_logits, t_caches), _ = _prefill(
        dtype, use_kernels)
    assert t_logits.dtype == torch.float32
    assert tuple(t_logits.shape) == tuple(j_logits.shape)
    _close(t_logits, j_logits, tol)
    for (jk, jv), (tk, tv) in zip(j_caches, t_caches):
        assert tuple(tk.shape) == tuple(jk.shape)
        _close(tk, jk, tol)
        _close(tv, jv, tol)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_three_decode_steps_match_reference(dtype, use_kernels):
    tol = DTYPES[dtype][2]
    (jmodel, params, _, j_caches), (model, tparams, _, t_caches), steps = \
        _prefill(dtype, use_kernels)
    for i, tok in enumerate(steps):
        pos = np.full((B,), PROMPT + i, np.int32)
        j_logits, j_caches = jmodel.decode(params, jnp.asarray(tok), j_caches,
                                           jnp.asarray(pos))
        t_logits, t_caches = model.decode(tparams, torch.from_numpy(tok).long(),
                                          t_caches, torch.from_numpy(pos))
        _close(t_logits, j_logits, tol)
    for (jk, jv), (tk, tv) in zip(j_caches, t_caches):
        _close(tk, jk, tol)
        _close(tv, jv, tol)


def _to_pages(dense_leaf, tables, num_pages):
    """[L,B,T,...] dense cache → [L,P,PAGE,...] pages via the block tables."""
    leaf = np.asarray(jnp.asarray(dense_leaf, jnp.float32))
    pages = np.zeros((leaf.shape[0], num_pages, PAGE) + leaf.shape[3:],
                     np.float32)
    for b, table in enumerate(tables):
        for i, page in enumerate(table):
            pages[:, page] = leaf[:, b, i * PAGE:(i + 1) * PAGE]
    return pages


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_three_paged_decode_steps_match_reference(dtype, use_kernels):
    """Both sides start from the same pages (the prefill caches scattered
    through a shuffled block table whose first page is the null page's
    neighbour) and take 3 paged decode steps."""
    jdt, tdt, tol = DTYPES[dtype]
    (jmodel, params, _, j_caches), (model, tparams, _, _), steps = _prefill(
        dtype, use_kernels)
    maxp = CACHE // PAGE
    num_pages = 1 + B * maxp
    order = np.random.default_rng(3).permutation(np.arange(1, num_pages))
    tables = order.reshape(B, maxp).astype(np.int32)
    j_pages = [tuple(jnp.asarray(_to_pages(x, tables, num_pages), jdt)
                     for x in kv) for kv in j_caches]
    t_pages = [tuple(torch.from_numpy(_to_pages(x, tables, num_pages)).to(tdt)
                     for x in kv) for kv in j_caches]
    bt_j, bt_t = jnp.asarray(tables), torch.from_numpy(tables)
    for i, tok in enumerate(steps):
        pos = np.full((B,), PROMPT + i, np.int32)
        j_logits, j_pages = jmodel.paged_decode(params, jnp.asarray(tok),
                                                j_pages, bt_j, jnp.asarray(pos))
        t_logits, t_pages = model.paged_decode(
            tparams, torch.from_numpy(tok).long(), t_pages, bt_t,
            torch.from_numpy(pos))
        _close(t_logits, j_logits, tol)
    for (jk, jv), (tk, tv) in zip(j_pages, t_pages):
        _close(tk, jk, tol)
        _close(tv, jv, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_windowed_kernel_route_keeps_the_window(dtype):
    """ROADMAP C2: the reference's kernel route drops the window, so the
    port's kernel route (window passed to flash attention) is held against
    the reference's plain path, on a config whose every layer has window 4
    (shorter than the 11-token prompt)."""
    tol = DTYPES[dtype][2]
    (jmodel, params, j_logits, _), (model, tparams, t_logits, t_caches), \
        steps = _prefill(dtype, True, window=4)
    _close(t_logits, j_logits, tol)
    full = _prefill(dtype, True)[1][2]
    assert float((t_logits - full).abs().max()) > 10 * tol


def test_model_facade_raises_for_what_is_not_ported():
    _, tcfg, _, _, tparams, tokens, _ = _setup("float32")
    model = Model(tcfg)
    # the dry-run helpers are ported: meta tensors with the reference's
    # shapes and dtypes (every arch: tests/test_torch_analysis.py)
    from repro.configs import SHAPES as JAX_SHAPES
    from repro_torch.configs import SHAPES
    from repro_torch.utils.tree import tree_leaves
    jmodel = JaxModel(jax_get_config("qwen2-0.5b", smoke=True))
    cell = SHAPES["decode_32k"]
    for got, want in ((model.init_shapes(), jmodel.init_shapes()),
                      (model.input_specs(cell),
                       jmodel.input_specs(JAX_SHAPES["decode_32k"])),
                      (model.decode_state_specs(cell),
                       jmodel.decode_state_specs(JAX_SHAPES["decode_32k"]))):
        got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
        assert all(t.is_meta for t in got)
        assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    # the training loss is ported (tests/test_torch_train.py holds it
    # against the reference)
    tok = torch.from_numpy(tokens).long()
    loss, metrics = model.loss(tparams, {"tokens": tok, "labels": tok})
    assert set(metrics) == {"ce", "aux"} and bool(torch.isfinite(loss))
    # the vlm prefill (llava) passes its patch embeddings through: they are
    # projected and prepended, one cache row each
    vcfg = dataclasses.replace(get_config("llava-next-mistral-7b",
                                          smoke=True), dtype=torch.float32)
    vlm = Model(vcfg)
    params = vlm.init(torch.Generator().manual_seed(0), "cpu")
    images = torch.randn((1, 3, vcfg.frontend.feat_dim))
    logits, caches = vlm.prefill(
        params, {"tokens": torch.ones((1, 2), dtype=torch.long),
                 "extra_embeds": images})
    assert tuple(logits.shape) == (1, vcfg.vocab_size)
    assert caches[0][0].shape[2] == 3 + 2


def test_model_init_matches_the_reference_tree():
    """``Model.init`` draws a tree of the reference's structure, shapes and
    dtypes on the device asked for."""
    jcfg, tcfg, jmodel, params, *_ = _setup("bfloat16")
    ours = Model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    theirs = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, params),
                               "cpu")

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
            assert a.device.type == "cpu"

    walk(ours, theirs)
