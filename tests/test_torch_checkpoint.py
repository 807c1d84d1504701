"""The port's checkpointer: the reference's ``tests/test_checkpoint.py``
cases on tensors, and checkpoints that cross packages — params plus an
AdamW state written by the port restore in the reference's
``Checkpointer`` leaf for leaf, and the reverse (same layout, leaves in
``jax.tree_util``'s order, bf16 widened to fp32 on disk)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.checkpoint import Checkpointer as RefCheckpointer  # noqa: E402
from repro.checkpoint import CheckpointSpec as RefSpec  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import (Checkpointer, CheckpointSpec,  # noqa: E402
                                    latest_step)
from repro_torch.optim import AdamWState, adamw_init  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402


def _tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.ones((2, 2), dtype=torch.bfloat16) * 1.5,
              "d": torch.tensor(7, dtype=torch.int32)},
    }


def test_roundtrip_including_bf16(tmp_path):
    ck = Checkpointer(CheckpointSpec(str(tmp_path)))
    tree = _tree()
    ck.save(3, tree, blocking=True)
    assert latest_step(str(tmp_path)) == 3
    got = ck.restore(3, tree)
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_async_save_then_wait(tmp_path):
    ck = Checkpointer(CheckpointSpec(str(tmp_path)))
    ck.save(1, _tree())          # returns immediately
    ck.wait()
    assert latest_step(str(tmp_path)) == 1


def test_gc_keeps_newest(tmp_path):
    ck = Checkpointer(CheckpointSpec(str(tmp_path), keep=2))
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(), blocking=True)
    names = sorted(os.listdir(tmp_path))
    assert names == ["step_00000003", "step_00000004"]


def test_no_tmp_dirs_after_save(tmp_path):
    ck = Checkpointer(CheckpointSpec(str(tmp_path)))
    ck.save(5, _tree(), blocking=True)
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]


def test_latest_step_empty(tmp_path):
    assert latest_step(str(tmp_path / "nope")) is None


def test_restore_onto_like_devices_and_dtypes(tmp_path):
    """Restore places each leaf on ``like``'s device in ``like``'s dtype
    (the reference's re-sharding argument is the distribution layer's)."""
    ck = Checkpointer(CheckpointSpec(str(tmp_path)))
    tree = _tree()
    ck.save(1, tree, blocking=True)
    like = {"a": torch.zeros((3, 4), dtype=torch.float64),
            "b": {"c": torch.zeros((2, 2), dtype=torch.float32),
                  "d": torch.zeros((), dtype=torch.int64)}}
    got = ck.restore(1, like)
    for a, b in zip(tree_leaves(got), tree_leaves(like)):
        assert a.device == b.device and a.dtype == b.dtype
    torch.testing.assert_close(got["b"]["c"], torch.full((2, 2), 1.5))


def test_snapshot_is_taken_at_save_time(tmp_path):
    ck = Checkpointer(CheckpointSpec(str(tmp_path)))
    tree = {"w": torch.zeros(4)}
    ck.save(1, tree)
    tree["w"].add_(1.0)          # the background write must not see this
    ck.wait()
    torch.testing.assert_close(ck.restore(1, tree)["w"], torch.zeros(4))


# -- checkpoints across packages ---------------------------------------------------

def _ref_state():
    rng = np.random.default_rng(0)
    params = {"embed": {"table": jnp.asarray(rng.standard_normal((6, 4)),
                                             jnp.bfloat16)},
              "stacks": [{"w": jnp.asarray(rng.standard_normal((2, 4, 4)),
                                           jnp.float32)}],
              "final_norm": {"scale": jnp.ones(4, jnp.bfloat16)}}
    opt = ref_optim.adamw_init(params)
    opt = opt._replace(
        step=jnp.asarray(5, jnp.int32),
        mu=jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.25), params),
        nu=jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 2.0), params))
    return {"params": params, "opt": opt, "data": {"step": 5}}


def _port_like(ref):
    params = bridge.from_numpy(
        jax.tree_util.tree_map(np.asarray, ref["params"]), "cpu")
    return {"params": params, "opt": adamw_init(params), "data": {"step": 0}}


def _assert_same(port_tree, ref_tree):
    port_leaves = tree_leaves(port_tree)
    ref_leaves = jax.tree_util.tree_leaves(ref_tree)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        p = p.float().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        np.testing.assert_array_equal(p, np.asarray(r, np.float32)
                                      if np.asarray(r).dtype.name == "bfloat16"
                                      else np.asarray(r))


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    ref = _ref_state()
    RefCheckpointer(RefSpec(str(tmp_path))).save(5, ref, blocking=True)
    like = _port_like(ref)
    got = Checkpointer(CheckpointSpec(str(tmp_path))).restore(5, like)
    assert isinstance(got["opt"], AdamWState)
    assert got["params"]["embed"]["table"].dtype == torch.bfloat16
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 5
    assert int(got["data"]["step"]) == 5
    _assert_same(got, ref)


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    ref = _ref_state()
    port = _port_like(ref)
    port["opt"] = bridge.adamw_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref["opt"]), "cpu")
    port["data"] = {"step": 5}
    Checkpointer(CheckpointSpec(str(tmp_path))).save(5, port, blocking=True)
    like = jax.tree_util.tree_map(jnp.zeros_like, ref)
    got = RefCheckpointer(RefSpec(str(tmp_path))).restore(5, like)
    assert got["params"]["embed"]["table"].dtype == jnp.bfloat16
    assert int(got["opt"].step) == 5
    _assert_same(port, got)
