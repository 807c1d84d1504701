"""The port's distribution layer on 4 gloo ranks, against the reference.

One JAX subprocess (4 host devices) runs the reference's collectives and
GPipe on seeded numpy inputs and records how JAX lays out a pod-major
spec; four ``mp.spawn`` runs of 4 gloo ranks (``spawn``: each rank starts
from a fresh import) hold the port's against them:

* ``collective_matmul`` and the pipeline within 1e-5, ``quantized_psum``
  and ``topk_psum`` within 1e-6 (the same integer sums, the same kept
  set), ``psum_scatter_grads`` within 1e-6; the local shards of a
  ``("pod", "data")`` dim on the devices JAX puts them on;
* on a 2×2 mesh, the sharded loss and grads of the Qwen2 and Kimi-K2 smoke
  models (params from the reference's init) against the port's own
  single-process run (the reference's sharded step fails on this tree):
  fp32 loss within 1e-5 and grads within 1e-4; the bf16 loss within the
  reference test's rtol 2e-2;
* every decoder arch's fp32 smoke loss and grads on the 2×2 mesh, with
  the port's own init, against one process (1e-5 / 1e-4; no JAX, so it
  also runs where only torch is installed);
* a checkpoint written by one process restored onto the mesh, each local
  shard bit-equal to its slice, and a sharded tree saved back whole.

These restate the reference's passing ``test_distribution.py`` cases.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(fn, *args):
    import torch.multiprocessing as mp
    mp.spawn(fn, args=(_free_port(),) + args, nprocs=WORLD, join=True)


def _init(rank: int, port: int):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)


# -- the reference, in a subprocess with 4 host devices -----------------------

_REF_SCRIPT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.parallel.collectives import (collective_matmul, psum_scatter_grads,
                                        quantized_psum, topk_psum)
from repro.parallel.compat import shard_map
from repro.parallel.pipeline import pipeline_apply

d = dict(np.load(sys.argv[1]))
out = {}
m1 = jax.make_mesh((4,), ("model",))
out["cm"] = shard_map(lambda x, w: collective_matmul(x, w, "model"), mesh=m1,
                      in_specs=(P(None, "model"), P()), out_specs=P())(
    d["cm_x"], d["cm_w"])
m2 = jax.make_mesh((4,), ("data",))
out["qp"] = shard_map(lambda g: quantized_psum(g[0], "data"), mesh=m2,
                      in_specs=(P("data"),), out_specs=P())(d["qp_g"])
out["tk"] = shard_map(lambda g: topk_psum(g[0], "data", 0.05), mesh=m2,
                      in_specs=(P("data"),), out_specs=P())(d["tk_g"])
rs = shard_map(lambda w, b: psum_scatter_grads({"w": w[0], "b": b[0]}, "data"),
               mesh=m2, in_specs=(P("data"), P("data")),
               out_specs={"w": P("data"), "b": P()})(d["rs_w"], d["rs_b"])
out["rs_w"], out["rs_b"] = rs["w"], rs["b"]
m3 = jax.make_mesh((4,), ("pod",))
out["pipe"] = pipeline_apply(lambda p, h: jnp.tanh(h @ p), d["pipe_w"],
                             d["pipe_x"], m3, axis="pod")
# where JAX puts the blocks of a ("pod", "data") dim on a 2x2x1 mesh
m4 = jax.make_mesh((2, 2, 1), ("pod", "data", "model"))
arr = jax.device_put(np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
                     NamedSharding(m4, P(("pod", "data"), None)))
ids = np.asarray(m4.device_ids)
start = np.zeros((2, 2, 1), np.int64)
for sh in arr.addressable_shards:
    pos = tuple(int(i) for i in np.argwhere(ids == sh.device.id)[0])
    start[pos] = sh.index[0].start
out["pod_major_start"] = start
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {
        "cm_x": rng.standard_normal((8, 32)).astype(f32),
        "cm_w": (rng.standard_normal((32, 16)) * 0.1).astype(f32),
        "qp_g": rng.standard_normal((4, 64)).astype(f32),
        "tk_g": rng.standard_normal((4, 256)).astype(f32),
        "rs_w": rng.standard_normal((4, 8, 3)).astype(f32),
        "rs_b": rng.standard_normal((4, 5)).astype(f32),
        "pipe_w": (rng.standard_normal((4, 2, 16, 16)) * 0.3).astype(f32),
        "pipe_x": rng.standard_normal((8, 4, 16)).astype(f32),
    }


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF_SCRIPT),
                          str(d / "in.npz"), str(d / "out.npz")],
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return inputs, dict(np.load(d / "out.npz"))


# -- run 1: collectives, pipeline, pod-major layout ---------------------------

def _collectives_worker(rank, port, inputs, ref):
    _init(rank, port)
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel.collectives import (collective_matmul,
                                                  psum_scatter_grads,
                                                  quantized_psum, topk_psum)
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.parallel.sharding import place
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}

    m1 = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    ks = 32 // 4
    cm = collective_matmul(t["cm_x"][:, rank * ks:(rank + 1) * ks],
                           t["cm_w"], m1, "model")
    np.testing.assert_allclose(cm.numpy(), ref["cm"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cm.numpy(), inputs["cm_x"] @ inputs["cm_w"],
                               rtol=1e-4, atol=1e-4)

    m2 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    qp = quantized_psum(t["qp_g"][rank], m2, "data")
    np.testing.assert_allclose(qp.numpy(), ref["qp"], rtol=1e-6, atol=1e-6)
    tk = topk_psum(t["tk_g"][rank], m2, "data", 0.05)
    np.testing.assert_allclose(tk.numpy(), ref["tk"], rtol=1e-6, atol=1e-6)
    assert np.array_equal(tk.numpy() != 0, ref["tk"] != 0)
    rs = psum_scatter_grads({"w": t["rs_w"][rank], "b": t["rs_b"][rank]},
                            m2, "data")
    np.testing.assert_allclose(rs["w"].numpy(),
                               ref["rs_w"][rank * 2:(rank + 1) * 2],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rs["b"].numpy(), ref["rs_b"], rtol=1e-6,
                               atol=1e-6)

    m3 = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    pipe = pipeline_apply(lambda p, h: torch.tanh(h @ p), t["pipe_w"],
                          t["pipe_x"], m3, axis="pod")
    np.testing.assert_allclose(pipe.numpy(), ref["pipe"], rtol=1e-5,
                               atol=1e-5)

    # pod-major: the local rows of a ("pod", "data") dim are the ones JAX
    # puts on the device at the same mesh coordinates
    m4 = make_debug_mesh(2, 1, multi_pod=True, device_type="cpu")
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    dt = place(x, m4, (("pod", "data"), None))
    start = int(ref["pod_major_start"][tuple(m4.get_coordinate())])
    assert torch.equal(dt.to_local(), x[start:start + 2])
    assert torch.equal(dt.full_tensor(), x)


def test_collectives_and_pipeline_match_reference(reference):
    inputs, ref = reference
    _spawn(_collectives_worker, inputs, ref)


# -- run 2: the sharded loss and grads on a 2x2 mesh --------------------------

CELL_B, CELL_S = 8, 16


def _cases():
    """arch → (numpy params from the reference's init, batch)."""
    import jax

    from repro.configs import get_config as ref_config
    from repro.models import Model as RefModel
    rng = np.random.default_rng(1)
    out = {}
    for arch in ("qwen2-0.5b", "kimi-k2-1t-a32b"):
        cfg = ref_config(arch, smoke=True)
        params = jax.tree_util.tree_map(
            np.asarray, jax.jit(RefModel(cfg).init)(jax.random.key(0)))
        batch = {k: rng.integers(0, cfg.vocab_size, (CELL_B, CELL_S),
                                 dtype=np.int32)
                 for k in ("tokens", "labels")}
        out[arch] = (params, batch)
    return out


def _port_model(arch, dtype):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(arch, smoke=True)
    return Model(dataclasses.replace(cfg, dtype=dtype))


def _tensors(params_np, batch_np, dtype):
    from repro_torch import bridge
    from repro_torch.utils.tree import tree_map
    params = bridge.from_numpy(params_np, device="cpu")
    if dtype == torch.float32:    # bf16 keeps the init's dtypes (fp32 router)
        params = tree_map(lambda a: a.float(), params)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    return params, batch


def _single(cases):
    """The port's single-process loss and grads → numpy."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.utils.tree import tree_leaves
    out = {}
    for arch, (params_np, batch_np) in cases.items():
        for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            params, batch = _tensors(params_np, batch_np, dtype)
            loss, _, grads = loss_and_grads(_port_model(arch, dtype), params,
                                            batch)
            out[arch, name] = (float(loss), [g.float().numpy()
                                             for g in tree_leaves(grads)])
    return out


def _sharded_worker(rank, port, cases, single):
    _init(rank, port)
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.parallel.sharding import (activation_rules, batch_specs,
                                               param_shardings, place,
                                               place_tree)
    from repro_torch.utils import logical_axis_rules
    from repro_torch.utils.tree import tree_leaves
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    cell = ShapeCell("dbg", CELL_S, CELL_B, "train")
    for (arch, name), (want_loss, want_grads) in single.items():
        dtype = torch.float32 if name == "fp32" else torch.bfloat16
        params_np, batch_np = cases[arch]
        params, batch = _tensors(params_np, batch_np, dtype)
        model = _port_model(arch, dtype)
        params = place_tree(params, param_shardings(mesh, params), mesh)
        sp = batch_specs(mesh, model.cfg, batch, cell)
        batch = {k: place(v, mesh, sp[k]) for k, v in batch.items()}
        with logical_axis_rules(activation_rules(mesh, cell), mesh), \
                implicit_replication():
            loss, _, grads = loss_and_grads(model, params, batch)
        loss = float(loss.full_tensor())
        grads = [g.full_tensor().float().numpy() for g in tree_leaves(grads)]
        tol = (dict(rtol=1e-5, atol=1e-5) if name == "fp32"
               else dict(rtol=2e-2))
        np.testing.assert_allclose(loss, want_loss, **tol,
                                   err_msg=f"{arch} {name} loss")
        if name == "bf16":
            # the reference test's bf16 check is the loss; a row-parallel
            # product's bf16 partial sums are rounded before their sum
            # (ROADMAP C23), so the grads are held in fp32
            continue
        for i, (g, w) in enumerate(zip(grads, want_grads)):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{arch} grad {i}")


def test_sharded_loss_and_grads_match_single_process():
    cases = _cases()
    _spawn(_sharded_worker, cases, _single(cases))


# -- run 3: every arch with the port's own init (no JAX) ----------------------

EVERY_ARCH = ("qwen2-0.5b", "llama3.2-1b", "glm4-9b", "kimi-k2-1t-a32b",
              "deepseek-v3-671b", "llava-next-mistral-7b", "hymba-1.5b",
              "rwkv6-1.6b")


def _every_arch_worker(rank, port):
    """Each decoder arch's fp32 smoke loss and grads on a 2×2 mesh against
    the same rank's single-process run; prints one line an arch and
    raises after all if any failed (so one run reports every arch)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import Model
    from repro_torch.parallel.sharding import (activation_rules, batch_specs,
                                               param_shardings, place,
                                               place_tree)
    from repro_torch.utils import logical_axis_rules
    from repro_torch.utils.tree import tree_leaves
    _init(rank, port)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    cell = ShapeCell("dbg", CELL_S, CELL_B, "train")
    failed = []
    for arch in EVERY_ARCH:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=torch.float32)
        model = Model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        g = torch.Generator().manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, (CELL_B, CELL_S),
                                  generator=g) for k in ("tokens", "labels")}
        loss, _, grads = loss_and_grads(model, params, batch)
        try:
            params_s = place_tree(params, param_shardings(mesh, params), mesh)
            sp = batch_specs(mesh, cfg, batch, cell)
            batch_s = {k: place(v, mesh, sp[k]) for k, v in batch.items()}
            with logical_axis_rules(activation_rules(mesh, cell), mesh), \
                    implicit_replication():
                loss_s, _, grads_s = loss_and_grads(model, params_s, batch_s)
            loss_rel = abs(float(loss_s.full_tensor()) - float(loss)) / abs(
                float(loss))
            worst = max(float((a.full_tensor() - b).norm()
                              / b.norm().clamp_min(1e-12))
                        for a, b in zip(tree_leaves(grads_s),
                                        tree_leaves(grads)))
            ok = loss_rel <= 1e-5 and worst <= 1e-4
            msg = (f"loss rel {loss_rel:.3e}, worst grad leaf rel_l2 "
                   f"{worst:.3e}")
        except RuntimeError as e:
            ok, msg = False, str(e).strip().splitlines()[-1][:200]
        if rank == 0:
            print(f"[2x2 gloo, torch {torch.__version__}] {arch}: "
                  f"{'ok' if ok else 'FAIL'}: {msg}", flush=True)
        if not ok:
            failed.append(arch)
    assert not failed, failed


def test_sharded_step_of_every_arch_matches_one_process():
    """Runs without JAX, so it also runs where only torch is installed:
    ``PYTHONPATH=src python -m pytest -q -s --noconftest
    tests/test_torch_distributed.py -k every_arch``."""
    _spawn(_every_arch_worker)


# -- run 4: sharded restore and a sharded save --------------------------------

def _restore_worker(rank, port, directory, params_np):
    _init(rank, port)
    from repro_torch import bridge
    from repro_torch.checkpoint.checkpointer import CheckpointSpec, Checkpointer
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel.sharding import (local_region, param_shardings,
                                               spec_leaves)
    from repro_torch.utils.tree import tree_leaves
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    full = bridge.from_numpy(params_np, device="cpu")
    specs = param_shardings(mesh, full)
    ck = Checkpointer(CheckpointSpec(directory))
    got = ck.restore(1, like=full, shardings=(specs, mesh))
    n_split = 0
    for g, f, s in zip(tree_leaves(got), tree_leaves(full),
                       spec_leaves(full, specs)):
        local = f
        for d, (start, n) in enumerate(local_region(mesh, f.shape,
                                                    g.placements)):
            local = local.narrow(d, start, n)
        assert g.to_local().dtype == f.dtype
        assert torch.equal(g.to_local(), local), s
        n_split += g.to_local().numel() < f.numel()
    assert n_split > 0
    # a sharded tree is saved whole (rank 0 writes) and restores plain
    ck.save(2, got, blocking=True)
    import torch.distributed as dist
    dist.barrier()
    back = ck.restore(2, like=full)
    for b, f in zip(tree_leaves(back), tree_leaves(full)):
        assert torch.equal(b, f)


def test_sharded_restore_is_bit_equal(tmp_path):
    import jax

    from repro.configs import get_config as ref_config
    from repro.models import Model as RefModel
    from repro_torch import bridge
    from repro_torch.checkpoint.checkpointer import CheckpointSpec, Checkpointer
    params_np = jax.tree_util.tree_map(np.asarray, jax.jit(RefModel(
        ref_config("qwen2-0.5b", smoke=True)).init)(jax.random.key(3)))
    Checkpointer(CheckpointSpec(str(tmp_path))).save(
        1, bridge.from_numpy(params_np, device="cpu"), blocking=True)
    _spawn(_restore_worker, str(tmp_path), params_np)
