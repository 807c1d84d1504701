"""The port's dry-run and the roofline's lowering half.

* ``parse_collectives`` (the port's copy) against the reference's on the
  reference test's HLO sample;
* the dispatch-mode counter on a sharded matmul of the fake 2×16×16 mesh:
  the one all-gather ``DTensor`` plans, with its bytes;
* ``lower_cell`` of the reference's slow test's cell (Qwen2 × decode_32k ×
  2×16×16): OK on 512 fake ranks, the argument bytes equal to a count of
  the local shards made from the reference's own specs;
* one decode cell per other family on 16×16 (MLA + MoE, RWKV, Hymba,
  Whisper, llava);
* ``analyse_cell``'s record and ``_attn_bytes_inflation`` against the
  reference's for every arch × cell;
* ``chunked_attention`` under the roofline's one-chunk hook against the
  reference's under its own, fp32 within 1e-5.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES as R_SHAPES  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import hlo_analysis as R_hlo  # noqa: E402
from repro.launch import roofline as R_roof  # noqa: E402
from repro.models import Model as RModel  # noqa: E402
from repro.models import attention as R_att  # noqa: E402
from repro.parallel import sharding as R_sh  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis, roofline  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_production_mesh  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.parallel.sharding import place  # noqa: E402
from test_analysis import HLO_SAMPLE  # noqa: E402


@pytest.mark.parametrize("mult", [1.0, 4.0])
def test_parse_collectives_matches_reference(mult):
    want = R_hlo.parse_collectives(HLO_SAMPLE, while_multiplier=mult)
    got = hlo_analysis.parse_collectives(HLO_SAMPLE, while_multiplier=mult)
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.count_by_kind == want.count_by_kind
    assert got.total_bytes == want.total_bytes


def test_step_counter_counts_one_all_gather():
    """[64,1024,4096] (batch over pod·data, K over model) @ [4096,1024]
    (columns over model): DTensor gathers the weight whole over model (one
    all-gather whose output is the [4096, 1024] fp32 weight on every
    device), multiplies each device's K slice and leaves the product
    partial over model."""
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        x = place(torch.empty(64, 1024, 4096, device="meta"), mesh,
                  (("pod", "data"), None, "model"))
        w = place(torch.empty(4096, 1024, device="meta"), mesh,
                  (None, "model"))
        with hlo_analysis.StepCounter() as c:
            y = x @ w
        stats = c.collectives()
    assert stats.count_by_kind == {"all-reduce": 0, "all-gather": 1,
                                   "reduce-scatter": 0, "all-to-all": 0,
                                   "collective-permute": 0}
    assert stats.bytes_by_kind["all-gather"] == 4096 * 1024 * 4
    assert stats.total_bytes == 4096 * 1024 * 4
    # the local product: [2, 1024, 256] @ [256, 1024]
    assert c.flops == 2 * 2 * 1024 * 256 * 1024
    assert tuple(y.to_local().shape) == (2, 1024, 1024)


def _spec_bytes(shape, dtype_bytes, spec, sizes):
    n = math.prod(shape)
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            n //= sizes[a]
    return n * dtype_bytes


def _ref_local_bytes(arch, shape_id):
    """Per-device argument bytes of a decode cell from the reference's
    specs on the 2×16×16 mesh: params, caches, token and pos."""
    cfg = r_get_config(arch)
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    sizes = dict(mesh.shape)
    model = RModel(cfg)
    cell = R_SHAPES[shape_id]
    total = 0
    for tree, specs in (
            (model.init_shapes(), R_sh.param_shardings(
                mesh, model.init_shapes())),
            (model.decode_state_specs(cell), R_sh.cache_specs(
                mesh, cfg, model.decode_state_specs(cell), cell)),
            (model.input_specs(cell), R_sh.batch_specs(
                mesh, cfg, model.input_specs(cell), cell))):
        for leaf, sh in zip(jax.tree_util.tree_leaves(tree),
                            jax.tree_util.tree_leaves(specs)):
            total += _spec_bytes(leaf.shape, leaf.dtype.itemsize,
                                 tuple(sh.spec), sizes)
    return total


def test_lower_cell_qwen2_decode_multipod():
    rec = dryrun.lower_cell("qwen2-0.5b", "decode_32k", multi_pod=True)
    assert rec["status"] == "OK"
    assert rec["n_chips"] == 512
    assert rec["collectives"]["scan_depth_multiplier"] == 1
    assert rec["memory"]["argument_size_in_bytes"] == _ref_local_bytes(
        "qwen2-0.5b", "decode_32k")
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"]["total_bytes_per_device"] > 0
    assert set(rec["collectives"]["bytes_by_kind"]) == set(
        R_hlo._COLLECTIVES)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "rwkv6-1.6b",
                                  "hymba-1.5b", "whisper-medium",
                                  "llava-next-mistral-7b"])
def test_lower_cell_decode_per_family(arch):
    rec = dryrun.lower_cell(arch, "decode_32k")
    assert rec["status"] == "OK", rec
    assert rec["n_chips"] == 256
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["cost"]["flops"] > 0


def test_lower_cell_skips_what_the_reference_skips():
    for arch in list_archs():
        for shape_id in SHAPES:
            from repro.configs import cell_applicable
            ok, _ = cell_applicable(r_get_config(arch), R_SHAPES[shape_id])
            if not ok:
                rec = dryrun.lower_cell(arch, shape_id)
                assert rec["status"] == "SKIP", (arch, shape_id)


def test_analyse_cell_record():
    rec = roofline.analyse_cell("qwen2-0.5b", "decode_32k")
    assert rec["status"] == "OK"
    for key in ("analytic", "hlo_flops_per_device", "hlo_crosscheck_ratio",
                "model_flops", "useful_flops_ratio", "roofline"):
        assert key in rec
    assert rec["hlo_crosscheck_ratio"] == pytest.approx(
        rec["hlo_flops_per_device"] * 256 / rec["analytic"]["flops"])
    r = rec["roofline"]
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r["step_time_lower_bound_s"] == max(
        r["compute_s"], r["memory_s"], r["collective_s"])
    assert r["collective_s"] == pytest.approx(
        rec["collectives"]["total_bytes_per_device"]
        / roofline.V5E.ici_bw)


def test_attn_bytes_inflation_matches_reference():
    for arch in list_archs():
        for shape_id in SHAPES:
            assert roofline._attn_bytes_inflation(
                get_config(arch), SHAPES[shape_id]) == \
                R_roof._attn_bytes_inflation(r_get_config(arch),
                                             R_SHAPES[shape_id])


def test_block_record_counts_one_block():
    cfg = get_config("qwen2-0.5b")
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        rec = roofline._block_record(cfg, SHAPES["decode_32k"], mesh,
                                     "dense", (0,), single_chunk=True)
    assert rec["flops"] > 0 and rec["bytes"] > 0
    assert rec["collective_bytes"] >= 0


@pytest.mark.parametrize("window", [None, 9])
def test_single_chunk_override_matches_reference(window):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    prev = R_att._CHUNK_OVERRIDE
    R_att._CHUNK_OVERRIDE = "single"
    try:
        want = np.asarray(R_att.chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
            q_chunk=8, kv_chunk=8))
    finally:
        R_att._CHUNK_OVERRIDE = prev
    with roofline._single_chunk_attention():
        assert attention._CHUNK_OVERRIDE == "single"
        got = attention.chunked_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            window=window, q_chunk=8, kv_chunk=8)
    assert attention._CHUNK_OVERRIDE is None
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # one chunk and eight: the same attention
    chunked = attention.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        window=window, q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), chunked.numpy(), rtol=1e-5,
                               atol=1e-5)
