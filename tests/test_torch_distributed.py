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
  reference test's rtol 2e-2, and the bf16 grads by the gate below;
* every decoder arch's fp32 smoke loss and grads on the 2×2 mesh, with
  the port's own init, against one process (1e-5 / 1e-4; no JAX, so it
  also runs where only torch is installed); its bf16 loss (2e-2) and
  grads: the worst leaf's distance from the fp32 single-process grads at
  most 1.25 × the single-process bf16 run's (an MoE arch is held so only
  where both runs route every position alike; the flips are printed);
  no product, combine or scan of the sharded step gets a ``DTensor``;
* a row-parallel bf16 product, and a column-parallel one's input grad,
  summed across ranks in fp32 before their one rounding, and no fp32
  copy of a ``DTensor`` weight made by ``linear`` or ``matmul_f32``;
* a checkpoint written by one process restored onto the mesh, each local
  shard bit-equal to its slice, and a sharded tree saved back whole.

These restate the reference's passing ``test_distribution.py`` cases.
"""
import collections
import contextlib
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
import time

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


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _worst_leaf(grads, want) -> float:
    """The largest relative L2 distance of a leaf of ``grads`` from the same
    leaf of ``want`` (``DTensor`` leaves made whole: every rank calls)."""
    from repro_torch.utils.tree import tree_leaves
    worst = 0.0
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        a, b = torch.as_tensor(_whole(a)).float(), torch.as_tensor(b).float()
        worst = max(worst, float((a - b).norm() / b.norm().clamp_min(1e-12)))
    return worst


@contextlib.contextmanager
def _routes():
    """The experts every MoE layer picks, whole and sorted, in call order."""
    from repro_torch.models import ffn
    seen, route = [], ffn.route

    def spy(*args, **kw):
        w, idx, aux = route(*args, **kw)
        seen.append(_whole(idx).detach().sort(-1).values)
        return w, idx, aux
    ffn.route = spy
    try:
        yield seen
    finally:
        ffn.route = route


def _flips(a: list, b: list) -> tuple[int, int]:
    """(positions whose experts differ, positions) over the MoE layers."""
    return (sum(int((x != y).any(-1).sum()) for x, y in zip(a, b)),
            sum(x.shape[0] for x in a))


BF16_GRAD_RATIO = 1.25


def _bf16_gate(single: float, sharded: float, flips: int) -> bool:
    """The sharded bf16 grads' worst leaf within ``BF16_GRAD_RATIO`` × the
    single-process bf16 run's, both against the fp32 grads.  Where the two
    runs route a position to other experts (an MoE arch), every leaf's
    grad differs by more than rounding, and the loss alone holds them."""
    return flips > 0 or sharded <= BF16_GRAD_RATIO * single


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
            with _routes() as routes:
                loss, _, grads = loss_and_grads(_port_model(arch, dtype),
                                                params, batch)
            out[arch, name] = (float(loss), [g.float().numpy()
                                             for g in tree_leaves(grads)],
                               routes)
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
    for (arch, name), (want_loss, want_grads, want_routes) in single.items():
        dtype = torch.float32 if name == "fp32" else torch.bfloat16
        params_np, batch_np = cases[arch]
        params, batch = _tensors(params_np, batch_np, dtype)
        model = _port_model(arch, dtype)
        params = place_tree(params, param_shardings(mesh, params), mesh)
        sp = batch_specs(mesh, model.cfg, batch, cell)
        batch = {k: place(v, mesh, sp[k]) for k, v in batch.items()}
        with logical_axis_rules(activation_rules(mesh, cell), mesh), \
                implicit_replication(), _routes() as routes:
            loss, _, grads = loss_and_grads(model, params, batch)
        loss = float(loss.full_tensor())
        grads = [g.full_tensor().float().numpy() for g in tree_leaves(grads)]
        tol = (dict(rtol=1e-5, atol=1e-5) if name == "fp32"
               else dict(rtol=2e-2))
        np.testing.assert_allclose(loss, want_loss, **tol,
                                   err_msg=f"{arch} {name} loss")
        if name == "bf16":
            f32_grads = single[arch, "fp32"][1]
            flips = _flips(want_routes, routes)[0]
            single_err = _worst_leaf(want_grads, f32_grads)
            sharded_err = _worst_leaf(grads, f32_grads)
            assert _bf16_gate(single_err, sharded_err, flips), (
                f"{arch} bf16 worst grad leaf: sharded {sharded_err:.3e}, "
                f"single {single_err:.3e}, flips {flips}")
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


@contextlib.contextmanager
def _inner_ops():
    """(calls, calls given a ``DTensor``), counted by name, of the plain
    products and scans that model code runs (torch's matmul and einsum,
    the WKV and Mamba scans)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import ssm
    calls, dtensor = collections.Counter(), collections.Counter()
    sites = [(torch, "matmul"), (torch, "einsum"), (ssm, "wkv_scan_ref"),
             (ssm, "mamba_scan_ref"), (ssm, "mamba_scan")]
    saved = [getattr(m, n) for m, n in sites]

    def spy(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            dtensor[name] += any(isinstance(a, DTensor) for a in args)
            return fn(*args, **kw)
        return call
    for (m, n), fn in zip(sites, saved):
        setattr(m, n, spy(n, fn))
    try:
        yield calls, dtensor
    finally:
        for (m, n), fn in zip(sites, saved):
            setattr(m, n, fn)


@contextlib.contextmanager
def _fp32_casts():
    """The shapes of the ``DTensor``s cast to fp32 (``.float()`` or
    ``.to(torch.float32)``) inside."""
    from torch.distributed.tensor import DTensor
    shapes, to, flt = [], torch.Tensor.to, torch.Tensor.float

    def spy_to(self, *args, **kw):
        if isinstance(self, DTensor) and (torch.float32 in args
                                          or kw.get("dtype") == torch.float32):
            shapes.append(tuple(self.shape))
        return to(self, *args, **kw)

    def spy_float(self, *args, **kw):
        if isinstance(self, DTensor):
            shapes.append(tuple(self.shape))
        return flt(self, *args, **kw)
    torch.Tensor.to, torch.Tensor.float = spy_to, spy_float
    try:
        yield shapes
    finally:
        torch.Tensor.to, torch.Tensor.float = to, flt


def _product_checks(mesh) -> None:
    """On the 2×2 mesh: causal attention over a split sequence against one
    process (fp32, 1e-6).  In bf16: a row-parallel ``linear`` (its
    contraction split over "model" in halves) whose partial sums are
    1 + 2^-8 and 2^-8,
    and a column-parallel one whose input grad's partial sums are the
    same.  Summed in fp32 before the one rounding they give 1 + 2^-7, as
    one process does; rounded first (ties to even) they give 1.  Neither
    ``linear`` nor ``matmul_f32`` (the head, the expert MLP) casts a
    ``DTensor`` weight to fp32, and their inner products get plain
    tensors."""
    from repro_torch.models.layers import linear, matmul_f32
    from repro_torch.parallel.sharding import place
    bf16, e = torch.bfloat16, 2.0 ** -8
    want = torch.full((2, 2, 2), 1 + 2 * e, dtype=bf16)
    x = torch.tensor([1, e, e, 0]).repeat(2, 2, 1)                # [2,2,4]
    w_row = torch.tensor([[1.0, 1.0], [1, 1], [1, 1], [0, 0]])    # [4,2]
    w_col = torch.zeros(4, 4)
    w_col[:2] = torch.tensor([1, e, e, 0])
    c = torch.tensor([1.0, 1, 1, 0])
    weights = [place(w_row.to(bf16), mesh, ("model", "data")),
               place(w_col.to(bf16), mesh, ("data", "model"))]
    table = place(torch.randn(8, 4).to(bf16), mesh, ("model", "data"))
    buf = place(torch.randn(4, 3, 4).to(bf16), mesh, ("model", None, None))
    gate = place(torch.randn(4, 4, 2).to(bf16), mesh,
                 ("model", "data", None))
    # causal attention over a sequence split across "model": the
    # sequence is made whole on each rank (the softmax spans it)
    from repro_torch.models.attention import _sdpa
    g = torch.Generator().manual_seed(3)
    qkv = [torch.randn(4, 8, 4, 4, generator=g) for _ in range(3)]
    causal = torch.tril(torch.ones(8, 8, dtype=torch.bool))
    att = _sdpa(*(place(t, mesh, ("data", "model", None, None))
                  for t in qkv), causal)
    assert torch.allclose(att.full_tensor(), _sdpa(*qkv, causal),
                          rtol=1e-6, atol=1e-6)
    with _fp32_casts() as casts, _inner_ops() as (calls, dtensor):
        y = linear({"w": weights[0]},
                   place(x.to(bf16), mesh, ("data", None, "model")))
        xs = place(x.to(bf16), mesh, ("data", None, None)).requires_grad_()
        y_col = linear({"w": weights[1]}, xs)
        (dx,) = torch.autograd.grad((y_col.float() * c).sum(), xs)
        head = matmul_f32(place(x.reshape(4, 4).to(bf16), mesh,
                                ("data", None)), table.t())
        experts = matmul_f32(buf, gate)
    assert torch.equal(y.full_tensor(), want)
    assert torch.equal(dx.full_tensor()[..., :2], want)
    assert head.dtype == experts.dtype == torch.float32
    weight_shapes = {tuple(t.shape) for t in weights + [table, gate]}
    weight_shapes |= {s[:-2] + s[:-3:-1] for s in weight_shapes}
    assert not weight_shapes & set(casts), casts
    assert calls["matmul"] and not sum(dtensor.values()), dtensor


def _sort_dispatch_check(mesh, cell) -> None:
    """The MoE sort dispatch (more than 32 experts, Kimi-K2's and
    DeepSeek-V3's) on the 2×2 mesh against one process, fp32: the output
    and the grads of the input and of every param within 1e-5; its
    combine gathers only a rank's own experts' rows."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.models.ffn import init_moe, moe_ffn
    from repro_torch.parallel.sharding import (activation_rules,
                                               param_shardings, place,
                                               place_tree)
    from repro_torch.utils import logical_axis_rules
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b", smoke=True),
                              dtype=torch.float32)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           n_experts=40))
    g = torch.Generator().manual_seed(2)
    p = init_moe(g, cfg, device="cpu")
    x = torch.randn(CELL_B, CELL_S, cfg.d_model, generator=g)
    c = torch.randn(CELL_B, CELL_S, cfg.d_model, generator=g)

    def run(p, x):
        leaves, spec = tree_flatten(p)
        live = [t.detach().requires_grad_() for t in [x] + leaves]
        y, _ = moe_ffn(tree_unflatten(spec, live[1:]), live[0], cfg)
        grads = torch.autograd.grad((y * c).sum(), live, allow_unused=True)
        return y, [torch.zeros(()) if g is None else g for g in grads]
    y, grads = run(p, x)
    ps = place_tree(p, param_shardings(mesh, p), mesh)
    with logical_axis_rules(activation_rules(mesh, cell), mesh), \
            implicit_replication():
        ys, grads_s = run(ps, place(x, mesh, ("data", None, None)))
    assert torch.allclose(ys.full_tensor(), y, rtol=1e-5, atol=1e-5)
    for a, b in zip(grads_s, grads):
        assert torch.allclose(_whole(a), b, rtol=1e-5, atol=1e-5)


def _every_arch_worker(rank, port, archs=EVERY_ARCH):
    """Each decoder arch's smoke loss and grads on a 2×2 mesh against the
    same rank's single-process run: fp32 (1e-5 / 1e-4) with the port's
    fp32 init, then bf16 with its bf16 init (the loss within 2e-2; the
    grads by ``_bf16_gate``, against the fp32 run on the same values);
    every product, combine and scan of the sharded steps gets plain
    tensors.  Prints one line an arch and raises after all if any failed
    (so one run reports every arch)."""
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
    from repro_torch.utils.tree import tree_map
    _init(rank, port)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    cell = ShapeCell("dbg", CELL_S, CELL_B, "train")
    with implicit_replication():
        _product_checks(mesh)
    _sort_dispatch_check(mesh, cell)

    def sharded(model, params, batch):
        params = place_tree(params, param_shardings(mesh, params), mesh)
        sp = batch_specs(mesh, model.cfg, batch, cell)
        batch = {k: place(v, mesh, sp[k]) for k, v in batch.items()}
        with logical_axis_rules(activation_rules(mesh, cell), mesh), \
                implicit_replication(), _routes() as routes, \
                _inner_ops() as (calls, dtensor):
            loss, _, grads = loss_and_grads(model, params, batch)
        if sum(dtensor.values()):
            raise RuntimeError(f"a DTensor reached {dict(dtensor)}")
        return float(loss.full_tensor()), grads, routes, calls

    failed = []
    for arch in archs:
        t0 = time.perf_counter()
        cfg16 = get_config(arch, smoke=True)
        cfg = dataclasses.replace(cfg16, dtype=torch.float32)
        model = Model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        g = torch.Generator().manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, (CELL_B, CELL_S),
                                  generator=g) for k in ("tokens", "labels")}
        loss, _, grads = loss_and_grads(model, params, batch)
        try:
            loss_s, grads_s, _, calls = sharded(model, params, batch)
            loss_rel = abs(loss_s - float(loss)) / abs(float(loss))
            worst = _worst_leaf(grads_s, grads)
            ok = loss_rel <= 1e-5 and worst <= 1e-4
            msg = (f"fp32 loss rel {loss_rel:.3e}, worst grad leaf rel_l2 "
                   f"{worst:.3e}")
            scan = {"rwkv": "wkv_scan_ref", "hybrid": "mamba_scan_ref"}.get(
                cfg.family)
            if scan and not calls[scan]:
                ok, msg = False, f"{msg}; {scan} never ran"
            # bf16: the same values in fp32 are the truth
            model16 = Model(cfg16)
            p16 = model16.init(torch.Generator().manual_seed(0), "cpu")
            _, _, truth = loss_and_grads(
                model, tree_map(lambda a: a.float(), p16), batch)
            with _routes() as routes1:
                loss1, _, grads1 = loss_and_grads(model16, p16, batch)
            loss2, grads2, routes2, _ = sharded(model16, p16, batch)
            flips, positions = _flips(routes1, routes2)
            single, shard_err = (_worst_leaf(grads1, truth),
                                 _worst_leaf(grads2, truth))
            loss16_rel = abs(loss2 - float(loss1)) / abs(float(loss1))
            ok = ok and loss16_rel <= 2e-2 and _bf16_gate(single, shard_err,
                                                          flips)
            msg += (f"; bf16 loss rel {loss16_rel:.3e}, worst grad leaf vs "
                    f"fp32: single {single:.3e}, sharded {shard_err:.3e} "
                    f"(x{shard_err / single:.3f}, <= {BF16_GRAD_RATIO})")
            if positions:
                msg += f", expert flips {flips}/{positions}"
        except RuntimeError as e:
            ok, msg = False, str(e).strip().splitlines()[-1][:200]
        if rank == 0:
            print(f"[2x2 gloo, torch {torch.__version__}] {arch}: "
                  f"{'ok' if ok else 'FAIL'}: {msg} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
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
