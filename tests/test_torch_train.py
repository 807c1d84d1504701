"""Training parity: the port's ``Model.loss`` and its grads against
``jax.value_and_grad`` of the reference's ``Model.loss``, on every
registered arch at its smoke config with the dtype set to fp32 on both
sides and params from the reference's init (``repro_torch.bridge``).

Tolerances: the loss and its metrics (``ce``, ``aux``, ``mtp_ce``) within
1e-5 relative, every grad leaf within 1e-4 relative L2 (both packages
compute the same fp32 math; their summation orders differ, and a grad is a
sum over the batch, the positions and, for tied embeddings, two uses).
Also: the kernel routes' plain versions differentiate on the CPU (RWKV-6's
chunked plain recurrence writes into a buffer), ``remat`` changes no grad,
and the reference's training and restart tests on the port's trainer.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
B, S = 2, 8


def _cfgs(arch: str):
    return (dataclasses.replace(ref_config(arch, smoke=True),
                                dtype=jnp.float32),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype=torch.float32))


def _batch(rcfg, seed: int = 3) -> dict:
    """tokens / labels [B,S] (plus the frontend's frames or patch
    embeddings), numpy."""
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    if rcfg.frontend is not None:
        key = "frames" if rcfg.family == "encdec" else "extra_embeds"
        fe = rcfg.frontend
        batch[key] = rng.standard_normal(
            (B, fe.n_tokens, fe.feat_dim)).astype(np.float32)
    return batch


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """(params as numpy, batch, loss, metrics, grad leaves) of the
    reference, jitted."""
    rcfg, _ = _cfgs(arch)
    model = RefModel(rcfg)
    params = jax.jit(model.init)(jax.random.key(0))
    batch = _batch(rcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, jbatch), has_aux=True))(params)
    return (jax.tree_util.tree_map(np.asarray, params), batch, float(loss),
            {k: float(v) for k, v in metrics.items()},
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    scale = np.linalg.norm(want)
    diff = np.linalg.norm(got - want)
    return float(diff / scale) if scale > 0 else float(diff)


def _port_loss(arch: str, use_kernels: bool = False, remat: bool = False):
    params_np, batch, *_ = _reference(arch)
    _, cfg = _cfgs(arch)
    params = bridge.from_numpy(params_np, "cpu")
    loss, metrics, grads = loss_and_grads(Model(cfg, use_kernels), params,
                                          _torch_batch(batch), remat=remat)
    return float(loss), {k: float(v) for k, v in metrics.items()}, [
        g.numpy() for g in tree_leaves(grads)]


@pytest.mark.parametrize("arch", list_archs())
def test_model_loss_and_grads_match_the_reference(arch):
    _, _, want_loss, want_metrics, want_grads = _reference(arch)
    loss, metrics, grads = _port_loss(arch)
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert set(metrics) == set(want_metrics)
    for name, value in want_metrics.items():
        assert metrics[name] == pytest.approx(value, rel=LOSS_RTOL,
                                              abs=1e-7), name
    assert len(grads) == len(want_grads)
    for i, (got, want) in enumerate(zip(grads, want_grads)):
        assert got.shape == want.shape, i
        assert _rel_l2(got, want) <= GRAD_REL_L2, (i, _rel_l2(got, want))
    assert any(np.abs(g).max() > 0 for g in grads)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "qwen2-0.5b",
                                  "kimi-k2-1t-a32b"])
def test_kernel_route_plain_versions_differentiate_on_the_cpu(arch):
    """With ``use_kernels`` the CPU runs each kernel's plain version (RWKV-6's
    chunked recurrence assigns into a buffer, the MoE the grouped expert
    MLP): its grads match the reference's plain route."""
    _, _, want_loss, _, want_grads = _reference(arch)
    loss, _, grads = _port_loss(arch, use_kernels=True)
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    for got, want in zip(grads, want_grads):
        assert _rel_l2(got, want) <= GRAD_REL_L2


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hymba-1.5b",
                                  "deepseek-v3-671b", "whisper-medium"])
def test_remat_changes_no_grad(arch):
    loss, _, grads = _port_loss(arch)
    loss_r, _, grads_r = _port_loss(arch, remat=True)
    assert loss_r == loss
    for got, want in zip(grads_r, grads):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_loss_on_the_card_refuses_the_kernel_route():
    """The CUDA kernels have no backward; on the CPU the kernel route is
    their plain versions and differentiates."""
    from repro_torch.models.transformer import _check_differentiable
    _check_differentiable(torch.zeros(1), True)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="no backward"):
            _check_differentiable(torch.zeros(1, device="cuda"), True)


# -- the reference's tests/test_system.py training cases, on the port ------------------

def test_training_reduces_loss():
    """A hundred-odd steps on a tiny model must reduce loss materially."""
    from repro_torch.launch.train import train
    res = train("llama3.2-1b", smoke=True, steps=120, batch=8, seq=32,
                ckpt_dir=None, resume=False, log_every=1000, device="cpu")
    assert res["last_loss"] < res["first_loss"] - 0.3, res


def test_train_checkpoint_restart_consistency(tmp_path):
    """Crash/restart: resuming from step k must give the same loss curve as
    an uninterrupted run (determinism of data + optimizer)."""
    from repro_torch.launch.train import train
    d = str(tmp_path / "ck")
    train("qwen2-0.5b", smoke=True, steps=12, batch=4, seq=16,
          ckpt_dir=d, resume=False, ckpt_every=6, log_every=1000,
          device="cpu")
    r2 = train("qwen2-0.5b", smoke=True, steps=18, batch=4, seq=16,
               ckpt_dir=d, resume=True, ckpt_every=6, log_every=1000,
               device="cpu")
    r_full = train("qwen2-0.5b", smoke=True, steps=18, batch=4, seq=16,
                   ckpt_dir=None, resume=False, log_every=1000, device="cpu")
    assert abs(r2["last_loss"] - r_full["last_loss"]) < 5e-3, (r2, r_full)


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_trainer_compresses_the_grads_when_asked(mode):
    from repro_torch.launch.train import train
    plain = train("qwen2-0.5b", smoke=True, steps=3, batch=2, seq=8,
                  ckpt_dir=None, resume=False, log_every=1000, device="cpu")
    comp = train("qwen2-0.5b", smoke=True, steps=3, batch=2, seq=8,
                 ckpt_dir=None, resume=False, log_every=1000, device="cpu",
                 compression=mode)
    assert comp["first_loss"] == plain["first_loss"]
    assert comp["losses"][1:] != plain["losses"][1:]
    assert all(np.isfinite(comp["losses"]))
