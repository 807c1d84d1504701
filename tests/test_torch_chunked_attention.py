"""The port's ``chunked_attention`` (plain torch, the flash-structured
forward of long prompts) against the JAX package's, and the two prefills
that run it above ``CHUNK_THRESHOLD``.

* ``chunked_attention`` on numpy inputs from a seed: causal and not, GQA
  (two query heads a KV head) and MLA-like (one KV head, Dk != Dv), with a
  window, lengths that are no chunk multiple (chunks of 8; the full-window
  case has rows that see no key), an explicit scale; the inner
  ``_flash_fwd``'s per-row log-sum-exp too;
* ``gqa_prefill`` at S = 2100 (past 2048 positions, the default chunks of
  2048: two Q chunks, two KV chunks, the last ones short) on one
  smoke-width layer;
* ``mla_prefill`` above the threshold, which both packages' tests lower
  with ``monkeypatch`` to reach it at smoke length, on both routes, and
  once at S = 2100 with the real threshold.

Tolerances: fp32 1e-5; bf16 relative L2 <= 2e-2 over the tensor, the JAX
package's bf16 differential tolerance (both sides round the unnormalised
probabilities to bf16 at the same point and differ in summation order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# (heads, kv heads, Dk, Dv)
HEADS = {"gqa": (4, 2, 16, 16), "mla": (8, 1, 24, 16)}


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


def _operands(dtype: str, heads: str, s: int, t: int, seed: int):
    jdt, tdt, _ = DTYPES[dtype]
    h, kvh, dk, dv = HEADS[heads]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((2, s, h, dk), (2, t, kvh, dk), (2, t, kvh, dv))]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("causal, window, s, t", [
    (True, None, 37, 37), (True, 5, 37, 37), (False, None, 21, 37),
    (False, 6, 29, 21)], ids=["causal", "causal-window", "full",
                              "full-window"])
def test_chunked_attention_matches_reference(causal, window, s, t, heads,
                                             dtype):
    tol = DTYPES[dtype][2]
    (rq, rk, rv), (q, k, v) = _operands(dtype, heads, s, t, s + t)
    kw = dict(causal=causal, window=window, q_chunk=8, kv_chunk=8)
    want = ref_attention.chunked_attention(rq, rk, rv, **kw)
    got = attention.chunked_attention(q, k, v, **kw)
    assert got.dtype == q.dtype and tuple(got.shape) == want.shape
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chunked_attention_explicit_scale_and_one_chunk(dtype):
    """An explicit scale, chunks longer than the sequence (one chunk each,
    clamped to S and T) and chunks of unequal length."""
    tol = DTYPES[dtype][2]
    (rq, rk, rv), (q, k, v) = _operands(dtype, "mla", 19, 19, 4)
    for qc, kc in ((64, 64), (4, 16)):
        kw = dict(causal=True, scale=0.3, q_chunk=qc, kv_chunk=kc)
        _close(attention.chunked_attention(q, k, v, **kw),
               ref_attention.chunked_attention(rq, rk, rv, **kw), tol)


@pytest.mark.parametrize("window", [0.0, 7.0])
def test_flash_fwd_log_sum_exp_matches_reference(window):
    """The inner forward returns the per-row log-sum-exp on the true length
    (what the backward of A9 reads), equal to the reference's on its padded
    operands over the rows they share."""
    s = 21
    (rq, rk, rv), (q, k, v) = _operands("float32", "gqa", s, s, 9)
    r_out, r_lse = ref_attention._flash_fwd(
        *(ref_attention._pad_axis(x, 1, 24) for x in (rq, rk, rv)),
        jnp.float32(window), causal=True, scale=16 ** -0.5, qc=8, kc=8,
        t_true=s)
    out, lse = attention._flash_fwd(q, k, v, window, causal=True,
                                    scale=16 ** -0.5, qc=8, kc=8)
    assert tuple(lse.shape) == (2, 4, s) and r_lse.shape == (2, 4, 24)
    _close(out, r_out[:, :s], 1e-5)
    _close(lse, r_lse[:, :, :s], 1e-5)


def test_window_off_values_disable_the_window():
    """None, 0 and anything >= 2^29 are all "no window"."""
    _, (q, k, v) = _operands("float32", "gqa", 20, 20, 2)
    kw = dict(causal=True, q_chunk=8, kv_chunk=8)
    none = attention.chunked_attention(q, k, v, window=None, **kw)
    for off in (0, -3, 1 << 29, 1 << 30):
        assert torch.equal(attention.chunked_attention(q, k, v, window=off,
                                                       **kw), none)
    assert not torch.equal(attention.chunked_attention(q, k, v, window=4,
                                                       **kw), none)


# -- the prefills that take it ------------------------------------------------------------

def _layer(arch: str, dtype: str, init):
    jdt, tdt, _ = DTYPES[dtype]
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype=jdt)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=tdt)
    rp = init(jax.random.key(1), rcfg)
    return rcfg, cfg, rp, bridge.from_numpy(
        jax.tree_util.tree_map(np.asarray, rp), "cpu")


def _hidden(rcfg, cfg, s: int, seed: int):
    x = np.random.default_rng(seed).standard_normal(
        (1, s, cfg.d_model)).astype(np.float32)
    positions = np.arange(s, dtype=np.int32)[None]
    return ((jnp.asarray(x, rcfg.dtype), jnp.asarray(positions)),
            (torch.from_numpy(x).to(cfg.dtype),
             torch.from_numpy(positions).long()))


@pytest.mark.parametrize("window", [None, 300], ids=["full", "window"])
def test_gqa_prefill_past_2048_positions_matches_reference(window):
    """One llava smoke layer (4/2 heads of 16) over 2100 positions, fp32:
    the reference's plain route runs its chunked_attention with the default
    chunks of 2048; the port's plain route runs its own, and its kernel
    route (on the CPU the flash kernel's plain version) keeps flash."""
    rcfg, cfg, rp, p = _layer("llava-next-mistral-7b", "float32",
                              ref_attention.init_gqa)
    s = 2100
    assert s * s > attention.CHUNK_THRESHOLD == ref_attention._CHUNK_THRESHOLD
    (rx, rpos), (x, pos) = _hidden(rcfg, cfg, s, 3)
    want, (rk, rv) = ref_attention.gqa_prefill(rp, rx, rcfg, rpos, window)
    for use_kernels in (False, True):
        got, (k, v) = attention.gqa_prefill(p, x, cfg, pos, window,
                                            use_kernels)
        _close(got, want, 1e-5)
        _close(k, rk, 1e-5)
        _close(v, rv, 1e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_prefill_above_the_threshold_matches_reference(dtype, use_kernels,
                                                           monkeypatch):
    """Both packages' threshold lowered to 64, so a 24-token MLA prefill
    (s·s = 576) runs chunked_attention in both; the port's rmsnorm kernel
    route runs its plain version on the CPU.  The chunked route differs
    from the [S, T] one (it is what ran)."""
    tol = DTYPES[dtype][2]
    rcfg, cfg, rp, p = _layer("deepseek-v3-671b", dtype,
                              ref_attention.init_mla)
    (rx, rpos), (x, pos) = _hidden(rcfg, cfg, 24, 5)
    unchunked, _ = attention.mla_prefill(p, x, cfg, pos, use_kernels)
    monkeypatch.setattr(ref_attention, "_CHUNK_THRESHOLD", 64)
    monkeypatch.setattr(attention, "CHUNK_THRESHOLD", 64)
    calls = []
    chunked = attention.chunked_attention
    monkeypatch.setattr(attention, "chunked_attention",
                        lambda *a, **kw: calls.append(a[0].shape)
                        or chunked(*a, **kw))
    want, (rc, rr) = ref_attention.mla_prefill(rp, rx, rcfg, rpos)
    got, (c, r) = attention.mla_prefill(p, x, cfg, pos, use_kernels)
    assert calls == [(1, 24, cfg.n_heads, cfg.mla.kv_lora_rank
                      + cfg.mla.qk_rope_head_dim)]
    _close(got, want, tol)
    _close(c, rc, tol)
    _close(r, rr, tol)
    if dtype == "bfloat16":
        assert not torch.equal(got, unchunked)


def test_mla_prefill_past_2048_positions_matches_reference():
    """The DeepSeek smoke MLA layer over 2100 positions at the real
    threshold, fp32, both routes (MLA prefill is plain on either)."""
    rcfg, cfg, rp, p = _layer("deepseek-v3-671b", "float32",
                              ref_attention.init_mla)
    (rx, rpos), (x, pos) = _hidden(rcfg, cfg, 2100, 6)
    want, (rc, rr) = ref_attention.mla_prefill(rp, rx, rcfg, rpos)
    for use_kernels in (False, True):
        got, (c, r) = attention.mla_prefill(p, x, cfg, pos, use_kernels)
        _close(got, want, 1e-5)
        _close(c, rc, 1e-5)
        _close(r, rr, 1e-5)
