"""The five ``REPRO_*`` performance flags: the port against the JAX package
with each flag on, and each flag's own invariants.

Both packages read the same environment variables, so one
``monkeypatch.setenv`` flips both.  Inputs come from numpy seeds; params
from the reference's init, bridged with ``repro_torch.bridge``.

* ``chunked_ce``: the loss within 1e-5 relative and every grad leaf within
  1e-4 relative L2 of ``jax.value_and_grad`` with the flag on (llama3.2-1b
  smoke at one chunk and at three, DeepSeek-V3's MTP smoke config, fp32);
  the flag changes the port's loss by no more than that; under autograd no
  tensor of one chunk's logits size is saved for the backward (each chunk
  is recomputed), where the unchunked loss saves the whole ``[B,S,V]``;
* ``REPRO_CACHE_UPDATE=scatter``: GQA and MLA decode against the
  reference's scatter decode in fp32 at 1e-5; the port's two modes
  bit-equal;
* ``causal_skip``: ``chunked_attention`` at the reference test's shapes
  and at lengths whose last KV chunk is short, with and without a window,
  against the reference with the flag on at 1e-5, forward and grads (1e-4);
  the port on vs off bit-equal on every row that sees a key.  A row that
  sees no key (queries past the last key) is the exception in both
  packages: its output is the mean of the values of the chunks it
  computed, so skipping chunks changes it (0 when every chunk is skipped);
  the port matches the reference's value there;
* ``window_slice_decode``: Hymba smoke against the reference at 2e-2 in
  bf16 (relative L2) and 1e-5 in fp32, on both routes, with a window
  start clamped at 0 and one inside the cache;
* ``kv_quant``: the dense MLA decode on the same int8 cache against the
  reference's (1e-5 fp32, 2e-2 relative L2 bf16, as
  ``test_torch_mla.py`` holds dense MLA decode), the new int8 values and
  scales equal (at most one step apart on at most 1% of entries, counted),
  the cache dtypes and shapes, the logits within 5% of the bf16-cache
  decode (the reference's rule); the engines: ``paged_kv=True`` degrades to
  the dense slab in both, and the first dense admission raises in both
  (ROADMAP C19), the port's caches unchanged after the raise.
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

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.runtime import DegradationWarning as RefDegradationWarning  # noqa: E402
from repro.serving import InferenceEngine as RefEngine  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro_torch import bridge, flags  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.runtime.guard import DegradationWarning  # noqa: E402
from repro_torch.serving import InferenceEngine, Request  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
FLAGS = ("REPRO_CACHE_UPDATE", "REPRO_CHUNKED_CE", "REPRO_CAUSAL_SKIP",
         "REPRO_WINDOW_SLICE_DECODE", "REPRO_KV_QUANT")


@pytest.fixture(autouse=True)
def _flags_off(monkeypatch):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)


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


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    scale = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / scale) if scale else float(
        np.linalg.norm(got - want))


def _cfgs(arch: str, dtype: str):
    jdt, tdt, _ = DTYPES[dtype]
    return (dataclasses.replace(ref_config(arch, smoke=True), dtype=jdt),
            dataclasses.replace(get_config(arch, smoke=True), dtype=tdt))


def test_flags_read_the_reference_variables_and_defaults(monkeypatch):
    from repro import flags as ref_flags
    names = ("cache_update_mode", "chunked_ce", "causal_skip",
             "window_slice_decode", "kv_quant")
    for name in names:
        assert getattr(flags, name)() == getattr(ref_flags, name)()
    for var, value in zip(FLAGS, ("scatter", "1", "1", "1", "1")):
        monkeypatch.setenv(var, value)
    for name in names:
        assert getattr(flags, name)() == getattr(ref_flags, name)()
        assert getattr(flags, name)() in ("scatter", True)
    # anything but "scatter" is the where mode, in both packages
    monkeypatch.setenv("REPRO_CACHE_UPDATE", "bogus")
    assert flags.cache_update_mode() == ref_flags.cache_update_mode() == \
        "bogus"


# -- chunked_ce ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ce_case(arch: str, b: int, s: int):
    rcfg, cfg = _cfgs(arch, "float32")
    rmodel = RefModel(rcfg)
    rparams = jax.jit(rmodel.init)(jax.random.key(0))
    rng = np.random.default_rng(s)
    batch = {k: rng.integers(0, rcfg.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    return rcfg, cfg, rmodel, rparams, batch


def _ref_loss_and_grads(arch, b, s):
    _, _, rmodel, rparams, batch = _ce_case(arch, b, s)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: rmodel.loss(p, jbatch), has_aux=True)(rparams)
    return float(loss), jax.tree_util.tree_leaves(grads)


def _port_loss_and_grads(arch, b, s):
    _, cfg, _, rparams, batch = _ce_case(arch, b, s)
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, _, grads = loss_and_grads(Model(cfg), _tree(rparams), tbatch)
    return float(loss), tree_leaves(grads)


@pytest.mark.parametrize("arch, b, s", [("llama3.2-1b", 2, 16),
                                        ("llama3.2-1b", 1, 1536),
                                        ("deepseek-v3-671b", 2, 16)],
                         ids=["llama-one-chunk", "llama-three-chunks",
                              "deepseek-mtp"])
def test_chunked_ce_matches_reference(arch, b, s, monkeypatch):
    monkeypatch.setenv("REPRO_CHUNKED_CE", "1")
    want_loss, want_grads = _ref_loss_and_grads(arch, b, s)
    loss, grads = _port_loss_and_grads(arch, b, s)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    assert len(grads) == len(want_grads)
    for i, (got, want) in enumerate(zip(grads, want_grads)):
        assert _rel_l2(got, want) <= 1e-4, (i, _rel_l2(got, want))
    monkeypatch.setenv("REPRO_CHUNKED_CE", "0")
    off_loss, off_grads = _port_loss_and_grads(arch, b, s)
    assert loss == pytest.approx(off_loss, rel=1e-5)
    for got, want in zip(grads, off_grads):
        assert _rel_l2(got, want) <= 1e-4


def test_chunked_ce_saves_no_chunk_logits_for_the_backward(monkeypatch):
    """One chunk's fp32 logits are [B, sc, V]: under the flag no tensor that
    large is saved for the backward (each chunk is checkpointed); without
    it the whole [B, S, V] is."""
    b, s = 1, 1536
    _, cfg, _, rparams, batch = _ce_case("llama3.2-1b", b, s)
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    params = _tree(rparams)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    chunk_logits = b * 512 * cfg.vocab_size

    def saved_logits() -> list[int]:
        """Sizes of the vocab-wide tensors of at least a chunk's logits
        that autograd keeps for the backward."""
        sizes = []

        def pack(t):
            if t.shape[-1] == cfg.vocab_size and t.numel() >= chunk_logits:
                sizes.append(t.numel())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = Model(cfg).loss(params, tbatch)
        loss.backward()
        return sizes
    monkeypatch.setenv("REPRO_CHUNKED_CE", "1")
    assert saved_logits() == []
    monkeypatch.setenv("REPRO_CHUNKED_CE", "0")
    assert max(saved_logits()) == b * s * cfg.vocab_size


# -- REPRO_CACHE_UPDATE ------------------------------------------------------------

def _decode_operands(rcfg, mla: bool, seed: int):
    rng = np.random.default_rng(seed)
    b, t = 2, 16
    x1 = rng.standard_normal((b, 1, rcfg.d_model)).astype(np.float32)
    if mla:
        shapes = ((b, t, rcfg.mla.kv_lora_rank),
                  (b, t, rcfg.mla.qk_rope_head_dim))
    else:
        shapes = ((b, t, rcfg.n_kv_heads, rcfg.head_dim),) * 2
    cache = tuple(rng.standard_normal(sh).astype(np.float32) for sh in shapes)
    return x1, cache, np.array([5, 13], np.int32)


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_scatter_cache_update_matches_reference(kind, monkeypatch):
    arch = "deepseek-v3-671b" if kind == "mla" else "qwen2-0.5b"
    rcfg, cfg = _cfgs(arch, "float32")
    init = ref_attention.init_mla if kind == "mla" else ref_attention.init_gqa
    rp = init(jax.random.key(2), rcfg)
    p = _tree(rp)
    decode = {"gqa": (ref_attention.gqa_decode, attention.gqa_decode),
              "mla": (ref_attention.mla_decode, attention.mla_decode)}[kind]
    x1, cache, pos = _decode_operands(rcfg, kind == "mla", 9)
    runs = {}
    for mode in ("where", "scatter"):
        monkeypatch.setenv("REPRO_CACHE_UPDATE", mode)
        ry, rcache = decode[0](rp, jnp.asarray(x1),
                               tuple(jnp.asarray(c) for c in cache),
                               jnp.asarray(pos), rcfg)
        tcache = tuple(torch.from_numpy(c.copy()) for c in cache)
        y, new = decode[1](p, torch.from_numpy(x1), tcache,
                           torch.from_numpy(pos), cfg)
        assert all(a is b for a, b in zip(new, tcache))   # in place
        _close(y, ry, 1e-5)
        for got, want in zip(new, rcache):
            _close(got, want, 1e-5)
        runs[mode] = (y, new)
    assert torch.equal(runs["where"][0], runs["scatter"][0])
    for a, b in zip(runs["where"][1], runs["scatter"][1]):
        assert torch.equal(a, b)


# -- causal_skip -----------------------------------------------------------------

def _attn_operands(s: int, t: int, seed: int, h=4, kvh=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((2, s, h, d), (2, t, kvh, d), (2, t, kvh, d),
                          (2, s, h, d))]


def _seen(s: int, t: int, window):
    """[s] bool: the query row sees at least one key (causal, window)."""
    q = np.arange(s)[:, None]
    k = np.arange(t)[None, :]
    ok = k <= q
    if window:
        ok &= k > q - window
    return ok.any(1)


CASES = {
    # the reference test's shapes: chunks of 16 over 96 positions
    "ref-window": (96, 96, 24, 16),
    "ref-nowindow": (96, 96, None, 16),
    # the last KV chunk short (90 = 5 x 16 + 10)
    "short-window": (90, 90, 20, 16),
    "short-nowindow": (90, 90, None, 16),
    # queries past the last key (21 = 8 + 8 + 5): rows 26.. see no key; the
    # block at 24 computes only the short last chunk, the block at 32 none
    "no-key-rows": (40, 21, 6, 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_causal_skip_matches_reference_forward_and_grads(case, monkeypatch):
    s, t, window, chunk = CASES[case]
    q, k, v, dout = _attn_operands(s, t, s + t)
    kw = dict(causal=True, window=window, q_chunk=chunk, kv_chunk=chunk)
    monkeypatch.setenv("REPRO_CAUSAL_SKIP", "1")

    def ref_fn(q, k, v):
        return (ref_attention.chunked_attention(q, k, v, **kw)
                * jnp.asarray(dout)).sum()
    want = ref_attention.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    want_grads = jax.grad(ref_fn, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = attention.chunked_attention(tq, tk, tv, **kw)
    _close(got, want, 1e-5)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(dout))
    for g, w in zip(grads, want_grads):
        _close(g, w, 1e-4)

    monkeypatch.setenv("REPRO_CAUSAL_SKIP", "0")
    off = attention.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    seen = torch.from_numpy(_seen(s, t, window))
    assert torch.equal(got.detach()[:, seen], off[:, seen])
    if not bool(seen.all()):
        # the rows that see no key: both packages change them under the flag
        assert not torch.equal(got.detach()[:, ~seen], off[:, ~seen])
        assert float(got.detach()[:, 32:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_causal_skip_is_bit_equal_on_a_prefill(dtype, monkeypatch):
    """At the default chunks of 2048 and S = 2100 (the last chunk short),
    the one skipped pair adds exact zeros: on vs off bit-equal, in bf16
    too."""
    _, tdt, _ = DTYPES[dtype]
    q, k, v, _ = (torch.from_numpy(a).to(tdt)
                  for a in _attn_operands(2100, 2100, 3, h=2, kvh=1, d=8))
    runs = []
    for value in ("0", "1"):
        monkeypatch.setenv("REPRO_CAUSAL_SKIP", value)
        runs.append(attention.chunked_attention(q[:1], k[:1], v[:1],
                                                causal=True))
    assert torch.equal(*runs)


def test_causal_skip_skips_the_chunks_it_should(monkeypatch):
    """Count the chunk pairs computed at S = T = 90 in chunks of 16 (6 x 6,
    the last short): every pair without the flag, the 21 on or below the
    diagonal with it, fewer again under a window of 20."""
    calls = []
    mask = attention._chunk_mask

    def counted(*args):
        calls.append(1)
        return mask(*args)
    monkeypatch.setattr(attention, "_chunk_mask", counted)
    q, k, v, _ = (torch.from_numpy(a)
                  for a in _attn_operands(90, 90, 1))
    counts = {}
    for value in ("0", "1"):
        for window in (None, 20):
            monkeypatch.setenv("REPRO_CAUSAL_SKIP", value)
            calls.clear()
            attention.chunked_attention(q, k, v, causal=True, window=window,
                                        q_chunk=16, kv_chunk=16)
            counts[value, window] = len(calls)
    assert counts["0", None] == counts["0", 20] == 36
    assert counts["1", None] == 21
    # window 20: a query chunk's first row reaches 19 positions back, so it
    # computes its own chunk and up to the two before it: 1 + 2 + 4 x 3
    assert counts["1", 20] == 15
    # non-causal attention never skips
    monkeypatch.setenv("REPRO_CAUSAL_SKIP", "1")
    calls.clear()
    attention.chunked_attention(q, k, v, causal=False, q_chunk=16,
                                kv_chunk=16)
    assert len(calls) == 36


# -- window_slice_decode ------------------------------------------------------------

HYMBA_CACHE = 40


@functools.lru_cache(maxsize=None)
def _hymba(dtype: str):
    rcfg, cfg = _cfgs("hymba-1.5b", dtype)
    rmodel = RefModel(rcfg)
    return rcfg, cfg, rmodel, rmodel.init(jax.random.key(0))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("prompt", [2, 16])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_window_slice_decode_matches_reference(dtype, prompt, use_kernels,
                                               monkeypatch):
    """Hymba smoke: window 8, 4 meta tokens, global layers 0 and 2 of 3, a
    44-slot cache (8 + 1 + 4 < 44, so the slice engages).  A 2-token prompt
    puts the decode positions (6, 7) below the window: the slice starts at
    0."""
    tol = DTYPES[dtype][2]
    rcfg, cfg, rmodel, rparams = _hymba(dtype)
    cache_len = HYMBA_CACHE + cfg.meta_tokens
    assert cfg.window + 1 + cfg.meta_tokens < cache_len
    rng = np.random.default_rng(prompt)
    tokens = rng.integers(1, rcfg.vocab_size, (2, prompt)).astype(np.int32)
    steps = rng.integers(1, rcfg.vocab_size, (2, 2)).astype(np.int32)
    monkeypatch.setenv("REPRO_WINDOW_SLICE_DECODE", "1")
    r_logits, r_caches = rmodel.prefill(rparams,
                                        {"tokens": jnp.asarray(tokens)},
                                        cache_len=cache_len)
    model = Model(cfg, use_kernels=use_kernels)
    params = _tree(rparams)
    logits, caches = model.prefill(
        params, {"tokens": torch.from_numpy(tokens).long()},
        cache_len=cache_len)
    for i, tok in enumerate(steps):
        pos = np.full((2,), prompt + i, np.int32)
        r_logits, r_caches = rmodel.decode(rparams, jnp.asarray(tok),
                                           r_caches, jnp.asarray(pos))
        logits, caches = model.decode(params, torch.from_numpy(tok).long(),
                                      caches, torch.from_numpy(pos))
        _close(logits, r_logits, tol)


def test_window_slice_decode_changes_nothing_in_fp32(monkeypatch):
    """The slice reads every slot the mask let through: the port on vs off
    within 1e-5 in fp32, and the flag does not engage where the window
    covers the cache."""
    rcfg, cfg, _, rparams = _hymba("float32")
    params = _tree(rparams)
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(1, rcfg.vocab_size,
                                           (2, 16))).long()
    tok = torch.from_numpy(rng.integers(1, rcfg.vocab_size, (2,))).long()
    pos = torch.full((2,), 16, dtype=torch.int32)
    model = Model(cfg)
    out = {}
    for value in ("0", "1"):
        monkeypatch.setenv("REPRO_WINDOW_SLICE_DECODE", value)
        _, caches = model.prefill(params, {"tokens": tokens},
                                  cache_len=HYMBA_CACHE + cfg.meta_tokens)
        out[value] = model.decode(params, tok, caches, pos)[0]
    _close(out["1"], out["0"], 1e-5)
    calls = []
    sdpa = attention._sdpa
    monkeypatch.setattr(attention, "_sdpa",
                        lambda q, k, *a, **kw: calls.append(k.shape[1])
                        or sdpa(q, k, *a, **kw))
    monkeypatch.setenv("REPRO_WINDOW_SLICE_DECODE", "1")
    _, caches = model.prefill(params, {"tokens": tokens},
                              cache_len=HYMBA_CACHE + cfg.meta_tokens)
    calls.clear()
    model.decode(params, tok, caches, pos)
    # layer 1 is windowed: it reads window + 1 slots; 0 and 2 the cache
    assert calls == [HYMBA_CACHE + 4, cfg.window + 1, HYMBA_CACHE + 4]
    # a cache of 8 + 4 slots: w + 1 + meta = 13 is not below it, so every
    # layer reads the whole cache under the mask, as without the flag
    _, caches = model.prefill(params, {"tokens": tokens[:, :6]},
                              cache_len=8 + cfg.meta_tokens)
    calls.clear()
    model.decode(params, tok, caches, torch.full((2,), 6, dtype=torch.int32))
    assert calls == [8 + 4] * 3


# -- kv_quant ----------------------------------------------------------------------

def _quantise(c):
    """The reference test's recipe: per-token absmax scale / 127."""
    scale = np.maximum(np.abs(c).max(-1), 1e-6) / 127.0
    q = np.clip(np.round(c / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float16)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kv_quant_mla_decode_matches_reference(dtype, monkeypatch):
    tol = DTYPES[dtype][2]
    rcfg, cfg = _cfgs("deepseek-v3-671b", dtype)
    rp = ref_attention.init_mla(jax.random.key(3), rcfg)
    p = _tree(rp)
    rng = np.random.default_rng(11)
    b, t = 4, 32
    x1 = rng.standard_normal((b, 1, rcfg.d_model)).astype(NP[dtype])
    c = rng.standard_normal((b, t, rcfg.mla.kv_lora_rank)).astype(np.float32)
    r = rng.standard_normal((b, t, rcfg.mla.qk_rope_head_dim)).astype(
        NP[dtype])
    c_q, c_s = _quantise(c)
    pos = np.array([0, 5, 17, 31], np.int32)
    monkeypatch.setenv("REPRO_KV_QUANT", "1")
    ry, rcache = ref_attention.mla_decode(
        rp, jnp.asarray(x1), tuple(map(jnp.asarray, (c_q, c_s, r))),
        jnp.asarray(pos), rcfg)
    cache = (torch.from_numpy(c_q.copy()), torch.from_numpy(c_s.copy()),
             bridge.array_to_tensor(r, "cpu"))
    y, new = attention.mla_decode(p, bridge.array_to_tensor(x1, "cpu"),
                                  cache, torch.from_numpy(pos), cfg)
    assert all(a is b for a, b in zip(new, cache))        # in place
    assert [leaf.dtype for leaf in new] == [torch.int8, torch.float16,
                                            cfg.dtype]
    _close(y, ry, tol)
    rows = np.arange(b)
    got_q = new[0].numpy()[rows, pos].astype(np.int32)
    want_q = np.asarray(rcache[0])[rows, pos].astype(np.int32)
    apart = np.abs(got_q - want_q)
    assert apart.max() <= 1 and (apart > 0).sum() <= 0.01 * apart.size, (
        f"{(apart > 0).sum()} of {apart.size} int8 entries differ")
    np.testing.assert_array_equal(new[1].numpy()[rows, pos],
                                  np.asarray(rcache[1])[rows, pos])
    _close(new[2], rcache[2], tol)
    # every other slot is untouched
    keep = np.ones((b, t), bool)
    keep[rows, pos] = False
    np.testing.assert_array_equal(new[0].numpy()[keep], c_q[keep])


def test_kv_quant_cache_and_decode_on_the_model(monkeypatch):
    """The reference's rule on the port: DeepSeek-V3 smoke decode on the
    int8 cache made from the prefill's latent within 5% (max |diff| / max
    |ref|) of the bf16-cache decode; ``init_decode_caches`` gives the int8
    triple, paged caches stay in the model dtype."""
    cfg = get_config("deepseek-v3-671b", smoke=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = (torch.arange(16).reshape(2, 8) * 7) % cfg.vocab_size
    logits, caches = model.prefill(params, {"tokens": tokens}, cache_len=16)
    tok = logits.argmax(-1)
    pos = torch.full((2,), 8, dtype=torch.int32)
    d0, _ = model.decode(params, tok, [tuple(x.clone() for x in c)
                                       for c in caches], pos)
    monkeypatch.setenv("REPRO_KV_QUANT", "1")
    quant = []
    for ck, rk in caches:
        q, s = _quantise(ck.float().numpy())
        quant.append((torch.from_numpy(q), torch.from_numpy(s), rk))
    d1, new = model.decode(params, tok, quant, pos)
    assert new[0][0].dtype == torch.int8
    rel = float((d0.float() - d1.float()).abs().max()) / float(
        d0.float().abs().max())
    assert rel < 0.05, rel
    dense = Model(cfg).decode_state_specs(ShapeCell("tick", 16, 2,
                                                    "decode"))
    assert [leaf.dtype for leaf in dense[0]] == [torch.int8, torch.float16,
                                                 cfg.dtype]
    pages = Model(cfg).init_paged_caches(4, 8, "cpu")
    assert {leaf.dtype for stack in pages for leaf in stack} == {cfg.dtype}


def _engines(paged: bool):
    rcfg = ref_config("deepseek-v3-671b", smoke=True)
    cfg = get_config("deepseek-v3-671b", smoke=True)
    rparams = RefModel(rcfg).init(jax.random.key(0))
    common = dict(max_slots=2, max_len=32, seed=3, paged_kv=paged,
                  page_size=8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref = RefEngine(RefModel(rcfg), rparams, **common)
        port = InferenceEngine(Model(cfg), _tree(rparams), **common)
    return ref, port, caught


def test_kv_quant_paged_mla_degrades_to_the_dense_slab(monkeypatch):
    monkeypatch.setenv("REPRO_KV_QUANT", "1")
    ref, port, caught = _engines(paged=True)
    assert not ref.paged and not port.paged
    kinds = [w.category for w in caught]
    assert RefDegradationWarning in kinds and DegradationWarning in kinds
    messages = [str(w.message) for w in caught
                if w.category is DegradationWarning]
    assert any("kv_quant" in m and "dense slab" in m for m in messages)
    assert [leaf.dtype for leaf in port.caches[0]] == [
        torch.int8, torch.float16, port.cfg.dtype]
    monkeypatch.setenv("REPRO_KV_QUANT", "0")
    _, port, _ = _engines(paged=True)
    assert port.paged


def test_kv_quant_dense_admission_raises_in_both_engines(monkeypatch):
    """ROADMAP C19: the dense slab is the int8 triple, the prefill returns
    the bf16 latent pair; the reference's splice raises on the tuple
    arity, and the port's raises before it writes any leaf."""
    monkeypatch.setenv("REPRO_KV_QUANT", "1")
    ref, port, _ = _engines(paged=False)
    before = [leaf.clone() for leaf in tree_leaves(port.caches)]
    ref.submit(RefRequest(rid=0, prompt=[5, 9, 11], max_tokens=4))
    port.submit(Request(rid=0, prompt=[5, 9, 11], max_tokens=4))
    with pytest.raises(ValueError, match="arity mismatch: 2 != 3"):
        ref.step()
    with pytest.raises(ValueError, match="arity mismatch: 2 != 3"):
        port.step()
    after = tree_leaves(port.caches)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
