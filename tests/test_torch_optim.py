"""The port's optimizer against the JAX package's: AdamW, the LR schedules
and gradient compression, plus the reference's ``tests/test_optim.py``
cases on the port and the bridge of the reference's optimizer state.

Tolerances: AdamW's new params and moments within 1e-6 (fp32; the two
packages evaluate the same elementwise formulas, so only the summation
order of the global norm and ulp-level pow / sqrt differences remain; an
ulp of the clip scale moves a moment by ~1e-9 absolute); bf16 params
bit-equal after the cast back; the schedules within 1e-6 relative (fp32
``cos`` differs by an ulp between the packages, and ``1 + cos`` near the
end of the cosine amplifies that ulp ~400x); compression within 1e-6
(int8's round-trip and top-k's mask are exact given the same fp32
inputs).
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.optim import (AdamWState, CompressionState,  # noqa: E402
                               adamw_init, adamw_update, compress_grads,
                               cosine_schedule, global_norm,
                               init_compression, wsd_schedule)
from repro_torch.utils.tree import tree_leaves  # noqa: E402

NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _tree(rng, dtype):
    """A param-shaped tree: matrices (decayed), vectors (not decayed) and a
    stacked list, in the given dtype."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(NP[dtype])
    return {"w": a(8, 16), "b": a(16), "stacks": [{"k": a(2, 4, 4),
                                                   "scale": a(2, 4)}]}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves_np(tree):
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return [_np(x) for x in tree_leaves(tree)]
    return [_np(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
def test_adamw_three_steps_match_the_reference(dtype, clip_norm):
    rng = np.random.default_rng(0)
    params_np = _tree(rng, dtype)
    rparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    params = bridge.from_numpy(params_np, "cpu")
    rstate, state = ref_optim.adamw_init(rparams), adamw_init(params)
    for step in range(3):
        grads_np = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * 3).astype(np.float32)
            .astype(p.dtype), params_np)
        lr = 1e-2 * (step + 1)
        rparams, rstate, rmet = ref_optim.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, grads_np), rstate, rparams,
            lr, clip_norm=clip_norm)
        params, state, met = adamw_update(
            bridge.from_numpy(grads_np, "cpu"), state, params,
            torch.tensor(lr), clip_norm=clip_norm)
        np.testing.assert_allclose(_np(met["grad_norm"]),
                                   _np(rmet["grad_norm"]), rtol=1e-6)
        assert int(state.step) == int(rstate.step) == step + 1
        for got, want in zip(_leaves_np(params), _leaves_np(rparams)):
            if dtype == "bfloat16":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        for moment in ("mu", "nu"):
            for got, want in zip(_leaves_np(getattr(state, moment)),
                                 _leaves_np(getattr(rstate, moment))):
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert all(p.dtype == getattr(torch, dtype) for p in tree_leaves(params))
    assert all(m.dtype == torch.float32 for m in tree_leaves(state.mu))


def test_weight_decay_applies_to_matrices_only():
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    zeros = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    new, _, _ = adamw_update(zeros, adamw_init(params), params, 0.5,
                             weight_decay=0.1)
    torch.testing.assert_close(new["w"], torch.full((2, 2), 0.95))
    torch.testing.assert_close(new["b"], torch.ones(2))


def test_clipping_scales_the_update_like_the_reference():
    g = {"w": np.full((3, 3), 1e3, np.float32)}
    p = {"w": np.zeros((3, 3), np.float32)}
    rnew, _, rmet = ref_optim.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, g),
        ref_optim.adamw_init(jax.tree_util.tree_map(jnp.asarray, p)),
        jax.tree_util.tree_map(jnp.asarray, p), 0.1, clip_norm=0.5)
    tp = bridge.from_numpy(p, "cpu")
    new, _, met = adamw_update(bridge.from_numpy(g, "cpu"), adamw_init(tp),
                               tp, 0.1, clip_norm=0.5)
    np.testing.assert_allclose(float(met["grad_norm"]), 3e3, rtol=1e-6)
    np.testing.assert_allclose(_np(new["w"]), _np(rnew["w"]), rtol=1e-6)
    torch.testing.assert_close(global_norm(bridge.from_numpy(g, "cpu")),
                               torch.tensor(3e3))


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (200, 1000)])
def test_cosine_schedule_equals_the_reference(warmup, total):
    for step in list(range(0, total + 20, 7)) + [warmup, total]:
        want = float(ref_optim.cosine_schedule(step, 1e-3, warmup, total))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = float(cosine_schedule(s, 1e-3, warmup, total))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_wsd_schedule_equals_the_reference():
    for step in range(0, 100, 3):
        want = float(ref_optim.wsd_schedule(step, 1e-3, 10, 50, 20))
        got = float(wsd_schedule(torch.tensor(step), 1e-3, 10, 50, 20))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_compression_and_its_error_feedback_match_the_reference(mode):
    rng = np.random.default_rng(4)
    shapes = {"w": (40, 30), "b": (300,)}
    rstate = ref_optim.init_compression(
        {k: jnp.zeros(s) for k, s in shapes.items()}, mode)
    state = init_compression({k: torch.zeros(s) for k, s in shapes.items()},
                             mode)
    for _ in range(4):
        g = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
             for k, s in shapes.items()}
        rsent, rstate = ref_optim.compress_grads(
            jax.tree_util.tree_map(jnp.asarray, g), rstate, mode)
        sent, state = compress_grads(bridge.from_numpy(g, "cpu"), state, mode)
        for got, want in zip(_leaves_np(sent), _leaves_np(rsent)):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        for got, want in zip(_leaves_np(state.error),
                             _leaves_np(rstate.error)):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_compression_off_passes_the_grads_through():
    g = {"w": torch.ones(3)}
    state = init_compression(g, "none")
    assert state == CompressionState(error=None)
    out, same = compress_grads(g, state, "none")
    assert out is g and same is state


# -- the reference's tests/test_optim.py cases, on the port ------------------------

def test_adamw_minimizes_quadratic():
    target = torch.tensor([3.0, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    state = adamw_init(params)
    for _ in range(300):
        w = params["w"].clone().requires_grad_(True)
        g, = torch.autograd.grad(((w - target) ** 2).sum(), w)
        params, state, _ = adamw_update({"w": g}, state, params, lr=0.05,
                                        weight_decay=0.0)
    torch.testing.assert_close(params["w"], target, atol=0.05, rtol=0)


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    huge = {"w": torch.full((4,), 1e9)}
    new_params, state, metrics = adamw_update(huge, state, params, lr=0.1,
                                              clip_norm=1.0, weight_decay=0.0)
    assert float(metrics["grad_norm"]) > 1e8
    assert float(new_params["w"].abs().max()) < 1.0


def test_schedules_shape():
    lrs = [float(cosine_schedule(s, 1e-3, warmup=10, total=100))
           for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9           # warmup ascends
    assert lrs[-1] < lrs[20]                        # cosine descends
    w = [float(wsd_schedule(s, 1e-3, 10, 50, 20)) for s in range(90)]
    assert abs(w[30] - 1e-3) < 1e-9                 # stable plateau
    assert w[-1] < w[30]                            # decay tail


def test_int8_compression_error_feedback():
    """Error feedback: sum of transmitted grads converges to the true sum."""
    state = init_compression({"w": torch.zeros(64)}, "int8")
    rng = np.random.default_rng(0)
    true_sum = np.zeros(64)
    sent_sum = np.zeros(64)
    for _ in range(50):
        g = {"w": torch.from_numpy((rng.standard_normal(64) * 0.1)
                                   .astype(np.float32))}
        true_sum += g["w"].numpy()
        sent, state = compress_grads(g, state, "int8")
        sent_sum += sent["w"].numpy()
    resid = np.abs(true_sum - sent_sum).max()
    assert resid < 0.05, f"error feedback residual too large: {resid}"


def test_topk_compression_sparsity():
    state = init_compression({"w": torch.zeros(1000)}, "topk")
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                               .astype(np.float32))}
    sent, state = compress_grads(g, state, "topk")
    assert int((sent["w"] != 0).sum()) <= 20  # k_frac=0.01 of 1000 + ties


# -- the bridge of the optimizer state ------------------------------------------------

def test_bridge_rebuilds_the_reference_adamw_state():
    rparams = {"w": jnp.ones((2, 3), jnp.bfloat16), "b": jnp.zeros(3)}
    rstate = ref_optim.adamw_init(rparams)
    rstate = rstate._replace(step=jnp.asarray(7, jnp.int32),
                             mu={"w": jnp.full((2, 3), 0.5), "b": jnp.ones(3)})
    as_np = jax.tree_util.tree_map(np.asarray, rstate)
    state = bridge.adamw_state_from_numpy(as_np, "cpu")
    assert isinstance(state, AdamWState)
    assert state.step.dtype == torch.int32 and int(state.step) == 7
    assert state.mu["w"].dtype == torch.float32
    torch.testing.assert_close(state.mu["w"], torch.full((2, 3), 0.5))
    torch.testing.assert_close(state.nu["b"], torch.zeros(3))


def test_bridge_rebuilds_a_namedtuple_field_by_field():
    rstate = ref_optim.adamw_init({"w": jnp.ones(2)})
    out = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, rstate), "cpu")
    assert type(out) is type(rstate)
    assert int(out.step) == 0 and out.mu["w"].shape == (2,)
    empty = bridge.from_numpy(CompressionState(error=None), "cpu")
    assert empty == CompressionState(error=None)
