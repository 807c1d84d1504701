"""The training step's pieces against the reference: the cross-entropy
losses and their grads, the ``chunked_attention`` backward against
``jax.grad`` of the reference's
``chunked_attention`` (its flash custom VJP) and against the port's own
``_sdpa`` under autograd, and one ``make_train_step`` step against the
reference's jitted step from one state.

Tolerances (fp32): the chunked grads within 1e-5 of the reference's (the
same chunked fp32 math; only the order of the chunk sums and of the
query-head fold differ) and 1e-4 of ``_sdpa``'s autograd (another
algorithm: a softmax over the whole row, differentiated); the new params
of one train step within 1e-5 at the trainer's base LR of 1e-3 wherever
the grad entry exceeds 1e-6 (AdamW's first update is ``lr·g/(|g|+eps)``
with eps 1e-8, so an entry within a few eps of zero, e.g. an expert that
saw one token, turns the last bits of its fp32 sum into a visible update
difference); every entry within ``2·lr``, the most one step can move it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import ParallelConfig as RefParallel  # noqa: E402
from repro.launch.steps import make_train_step as ref_make_train_step  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

# (heads, kv heads, Dk, Dv, S, window, chunk): GQA without and with a
# window, S no chunk multiple (the last chunk short), MLA's heads over one
# latent head (V the first Dv columns' width), and a single chunk
CASES = {
    "gqa": (4, 2, 16, 16, 40, None, 16),
    "gqa_window": (4, 2, 16, 16, 40, 9, 16),
    "gqa_short_last_chunk": (6, 3, 8, 8, 37, None, 8),
    "mla_one_latent_head": (8, 1, 24, 16, 33, None, 16),
    "one_chunk": (2, 1, 8, 8, 12, None, 64),
}


def _operands(h, kvh, dk, dv, s, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((2, s, h, dk), (2, s, kvh, dk), (2, s, kvh, dv),
                  (2, s, h, dv)))


@pytest.mark.parametrize("s_chunk", [4, 6, 64])
def test_losses_and_their_grads_match_the_reference(s_chunk):
    """``softmax_xent`` (the gold logit gathered, the reference contracts a
    one-hot) and ``chunked_softmax_xent`` (the head inside a loop over
    sequence chunks; 6 does not divide 12, so the chunk halves to 3) with
    their grads, fp32, within 1e-6 relative."""
    from repro.models import losses as ref_losses
    from repro_torch.models import losses
    rng = np.random.default_rng(s_chunk)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    table = (rng.standard_normal((50, 16)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 12)).astype(np.int32)

    def ref(x, table):
        full = ref_losses.softmax_xent(jnp.einsum("bsd,vd->bsv", x, table),
                                       labels)
        return full, ref_losses.chunked_softmax_xent(x, table, labels,
                                                     s_chunk)
    want = [jax.value_and_grad(lambda a, b, i=i: ref(a, b)[i],
                               argnums=(0, 1))(x, table) for i in (0, 1)]
    tx, tt = (torch.from_numpy(a).requires_grad_(True) for a in (x, table))
    tl = torch.from_numpy(labels).long()
    got = [losses.softmax_xent(tx @ tt.t(), tl),
           losses.chunked_softmax_xent(tx, tt, tl, s_chunk)]
    for loss, (wloss, wgrads) in zip(got, want):
        assert loss.item() == pytest.approx(float(wloss), rel=1e-6)
        for g, w in zip(torch.autograd.grad(loss, (tx, tt)), wgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_backward_matches_the_reference_grad(case):
    h, kvh, dk, dv, s, window, chunk = CASES[case]
    q, k, v, dout = _operands(h, kvh, dk, dv, s)

    def ref_fn(q, k, v):
        out = ref_attention.chunked_attention(
            q, k, v, causal=True, window=window, q_chunk=chunk,
            kv_chunk=chunk)
        return jnp.sum(out * dout)
    want = jax.grad(ref_fn, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = attention.chunked_attention(tq, tk, tv, causal=True, window=window,
                                      q_chunk=chunk, kv_chunk=chunk)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_backward_matches_sdpa_autograd(case):
    h, kvh, dk, dv, s, window, chunk = CASES[case]
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _operands(h, kvh, dk, dv, s, seed=1))
    grads = []
    for chunked in (True, False):
        tq, tk, tv = (a.clone().requires_grad_(True) for a in (q, k, v))
        if chunked:
            out = attention.chunked_attention(tq, tk, tv, causal=True,
                                              window=window, q_chunk=chunk,
                                              kv_chunk=chunk)
        else:
            pos = torch.arange(s)
            out = attention._sdpa(tq, tk, tv, attention.causal_window_mask(
                pos, pos, window))
        grads.append(torch.autograd.grad(out, (tq, tk, tv), dout))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_mla_prefill_past_the_threshold_differentiates_through_chunks(
        monkeypatch):
    """The MLA prefill takes the chunked route past the threshold, and its
    grads through the shared latent (K and V both read c_kv) equal the
    plain route's."""
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", smoke=True),
                              dtype=torch.float32)
    rcfg = dataclasses.replace(ref_config("deepseek-v3-671b", smoke=True),
                               dtype=jnp.float32)
    rparams = jax.tree_util.tree_map(
        np.asarray, RefModel(rcfg).init(jax.random.key(1)))
    p = bridge.from_numpy(rparams["stacks"][0], "cpu")
    p = {k: v for k, v in p.items()}
    attn = {name: {k: w[0] for k, w in leaf.items()}
            for name, leaf in p["attn"].items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 12, cfg.d_model)).astype(np.float32))
    positions = torch.arange(12)[None]
    grads = []
    for threshold in (1 << 22, 16):
        monkeypatch.setattr(attention, "CHUNK_THRESHOLD", threshold)
        xs = x.clone().requires_grad_(True)
        y, _ = attention.mla_prefill(attn, xs, cfg, positions)
        grads.append(torch.autograd.grad(y.square().sum(), xs)[0])
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v3-671b"])
def test_one_train_step_matches_the_reference_step(arch):
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    rmodel = RefModel(rcfg)
    rparams = jax.jit(rmodel.init)(jax.random.key(0))
    ropt = ref_adamw_init(rparams)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, rcfg.vocab_size, (2, 8)).astype(np.int32)
             for k in ("tokens", "labels")}
    pcfg = dict(grad_compression="none", remat="none")
    # the trainer's base LR; at step 0 with no warmup the cosine gives it
    ref_step = jax.jit(ref_make_train_step(rmodel, RefParallel(**pcfg),
                                           base_lr=1e-3, warmup=0,
                                           total_steps=10))
    params = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                               "cpu")
    opt = bridge.adamw_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, ropt), "cpu")
    step = make_train_step(Model(cfg), ParallelConfig(**pcfg), base_lr=1e-3,
                           warmup=0, total_steps=10)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rnew, ropt2, rmet = ref_step(rparams, ropt, jbatch, jnp.int32(0))
    new, opt2, met = step(params, opt,
                          {k: torch.from_numpy(v).long()
                           for k, v in batch.items()}, 0)
    assert float(met["loss"]) == pytest.approx(float(rmet["loss"]), rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]),
                                                    rel=1e-4)
    assert int(opt2.step) == int(ropt2.step) == 1
    # the first moment after one step is (1 - b1)·g: the reference's grads
    rgrads = [np.asarray(m) / 0.1 for m in jax.tree_util.tree_leaves(ropt2.mu)]
    for got, want, g in zip(tree_leaves(new), jax.tree_util.tree_leaves(rnew),
                            rgrads):
        assert not got.requires_grad
        got, want = got.numpy(), np.asarray(want)
        settled = np.abs(g) > 1e-6          # |g|/(|g|+eps) within 1% of 1
        np.testing.assert_allclose(got[settled], want[settled], rtol=1e-5,
                                   atol=1e-5)
        assert np.abs(got - want).max(initial=0.0) <= 2 * 1e-3
