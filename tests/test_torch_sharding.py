"""The port's sharding rules against the JAX package's, spec for spec.

The reference's rules run on ``jax.sharding.AbstractMesh`` (no devices);
the port's on ``DeviceMesh``es of a fake world of 512 ranks held by this
process (``repro_torch.launch.mesh.fake_world``).  Both read only the
mesh's dim names and sizes, so every arch's full config is compared on the
16×16 and 2×16×16 production meshes and the 2×4 debug mesh.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES as R_SHAPES  # noqa: E402
from repro.configs import cell_applicable as r_applicable  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro.parallel import sharding as R  # noqa: E402
from repro.utils import sharding_ctx as R_ctx  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch.mesh import (dp_axes, fake_world,  # noqa: E402
                                     make_debug_mesh, make_production_mesh)
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel import sharding as T  # noqa: E402
from repro_torch.utils import (current_rules, logical_axis_rules,  # noqa: E402
                               shard)
from repro_torch.utils import sharding_ctx as T_ctx  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths  # noqa: E402

ARCHS = list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
FLAGS = list(itertools.product([True, False], repeat=3))


@pytest.fixture(scope="module")
def meshes():
    """name → (the port's DeviceMesh, the reference's AbstractMesh)."""
    with fake_world(512):
        yield {
            "16x16": make_production_mesh(device_type="cpu"),
            "2x16x16": make_production_mesh(multi_pod=True,
                                            device_type="cpu"),
            "2x4": make_debug_mesh(2, 4, device_type="cpu"),
        }


def _ref_mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def _ref_specs(tree):
    """[(keystr, spec tuple)] of a reference NamedSharding tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(k), tuple(s.spec)) for k, s in flat]


def _port_specs(tree, specs):
    return list(zip(tree_paths(tree), T.spec_leaves(tree, specs)))


def test_mesh_dims(meshes):
    assert meshes["2x16x16"].mesh_dim_names == ("pod", "data", "model")
    assert tuple(meshes["2x16x16"].shape) == (2, 16, 16)
    assert dp_axes(meshes["2x16x16"]) == ("pod", "data")
    assert dp_axes(meshes["16x16"]) == ("data",)


@pytest.mark.parametrize("arch", ARCHS)
def test_keystr_paths_match_reference(arch):
    cfg_r, cfg_t = r_get_config(arch), get_config(arch)
    ref = [jax.tree_util.keystr(k) for k, _ in
           jax.tree_util.tree_flatten_with_path(
               RModel(cfg_r).init_shapes())[0]]
    assert tree_paths(Model(cfg_t).init_shapes()) == ref


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(meshes, arch, mesh_name):
    ref_shapes = RModel(r_get_config(arch)).init_shapes()
    shapes = Model(get_config(arch)).init_shapes()
    rm, tm = _ref_mesh(mesh_name), meshes[mesh_name]
    for fsdp, tp, ep2d in FLAGS:
        kw = dict(fsdp=fsdp, tensor_parallel=tp, expert_2d=ep2d)
        want = _ref_specs(R.param_shardings(rm, ref_shapes, **kw))
        got = _port_specs(shapes, T.param_shardings(tm, shapes, **kw))
        assert got == want, (kw, set(got) ^ set(want))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_activation_rules_match_reference(meshes, mesh_name):
    rm, tm = _ref_mesh(mesh_name), meshes[mesh_name]
    for cell_id in [None] + list(SHAPES):
        for tp, sp, ep2d in FLAGS:
            kw = dict(tensor_parallel=tp, sequence_parallel=sp,
                      expert_2d=ep2d)
            want = R.activation_rules(
                rm, None if cell_id is None else R_SHAPES[cell_id], **kw)
            got = T.activation_rules(
                tm, None if cell_id is None else SHAPES[cell_id], **kw)
            assert got == want, (cell_id, kw)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(meshes, arch, mesh_name):
    cfg_r, cfg_t = r_get_config(arch), get_config(arch)
    rm, tm = _ref_mesh(mesh_name), meshes[mesh_name]
    for cell_id, cell in SHAPES.items():
        if not r_applicable(cfg_r, R_SHAPES[cell_id])[0]:
            continue
        r_inputs = RModel(cfg_r).input_specs(R_SHAPES[cell_id])
        t_inputs = Model(cfg_t).input_specs(cell)
        for tp in (True, False):
            want = {k: tuple(v.spec) for k, v in R.batch_specs(
                rm, cfg_r, r_inputs, R_SHAPES[cell_id],
                tensor_parallel=tp).items()}
            assert T.batch_specs(tm, cfg_t, t_inputs, cell,
                                 tensor_parallel=tp) == want
        if cell.step != "decode":
            continue
        r_caches = RModel(cfg_r).decode_state_specs(R_SHAPES[cell_id])
        t_caches = Model(cfg_t).decode_state_specs(cell)
        want = _ref_specs(R.cache_specs(rm, cfg_r, r_caches,
                                        R_SHAPES[cell_id]))
        got = _port_specs(t_caches, T.cache_specs(tm, cfg_t, t_caches, cell))
        assert got == want, cell_id


def test_cache_specs_kv_quant_scale_rule(meshes, monkeypatch):
    """DeepSeek-V3's int8 latent cache carries a [L, B, T] scale leaf with
    its own rule."""
    monkeypatch.setenv("REPRO_KV_QUANT", "1")
    cfg_r, cfg_t = r_get_config("deepseek-v3-671b"), get_config(
        "deepseek-v3-671b")
    for mesh_name in MESHES:
        for cell_id in ("decode_32k", "long_500k"):
            r_caches = RModel(cfg_r).decode_state_specs(R_SHAPES[cell_id])
            t_caches = Model(cfg_t).decode_state_specs(SHAPES[cell_id])
            assert any(leaf.dim() == 3 for leaf in
                       tree_leaves(t_caches)), "no scale leaf"
            want = _ref_specs(R.cache_specs(_ref_mesh(mesh_name), cfg_r,
                                            r_caches, R_SHAPES[cell_id]))
            got = _port_specs(t_caches, T.cache_specs(
                meshes[mesh_name], cfg_t, t_caches, SHAPES[cell_id]))
            assert got == want, (mesh_name, cell_id)


_AXIS = st.sampled_from([None, "pod", "data", "model", ("pod", "data"),
                         ("data", "model"), ("pod", "data", "model"),
                         ("model", "data")])


@settings(max_examples=150, deadline=None)
@given(mesh_name=st.sampled_from(list(MESHES)),
       dims=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 14, 16, 32, 64, 96]),
                     min_size=1, max_size=4),
       data=st.data())
def test_safe_spec_matches_reference(meshes, mesh_name, dims, data):
    axes = data.draw(st.lists(_AXIS, min_size=len(dims),
                              max_size=len(dims)))
    want = tuple(R.safe_spec(_ref_mesh(mesh_name), tuple(dims), *axes))
    assert T.safe_spec(meshes[mesh_name], tuple(dims), *axes) == want


_LOGICAL = ["batch", "seq", "embed", "heads", "kv_heads", "mlp", "expert",
            "vocab"]


@settings(max_examples=150, deadline=None)
@given(axes=st.lists(st.sampled_from(_LOGICAL + [None]), min_size=1,
                     max_size=5),
       rules=st.fixed_dictionaries({k: _AXIS for k in _LOGICAL}))
def test_logical_to_spec_matches_reference(axes, rules):
    assert T_ctx.logical_to_spec(axes, rules) == tuple(
        R_ctx.logical_to_spec(axes, rules))


def test_shard_is_the_identity_without_rules():
    x = torch.randn(2, 3, 4)
    assert current_rules() is None
    assert shard(x, "batch", "seq", "embed") is x
    with logical_axis_rules({"batch": "data"}):
        # rules but no mesh and a plain tensor: nothing to lay out
        assert shard(x, "batch", "seq", "embed") is x
    assert current_rules() is None


def test_to_placements_pod_major(meshes):
    from torch.distributed.tensor import Replicate, Shard
    m = meshes["2x16x16"]
    assert T.to_placements(m, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert T.to_placements(m, (None, None)) == [Replicate()] * 3
    with pytest.raises(ValueError):
        T.to_placements(m, (("data", "pod"),))
