"""The port's one-card cost model against the JAX package's.

* ``launch/analytic_cost.cell_cost``: FLOPs, bytes and every ``detail``
  term equal to the reference's at rel 1e-12, for every registered arch
  × every ``SHAPES`` cell, with every flag off, each of the five
  ``REPRO_*`` flags on alone, and all on (both packages read the same
  variables, so one ``monkeypatch.setenv`` flips both);
* ``launch/roofline``: ``roofline_terms`` (the reference's TPU v5e
  default) and ``model_flops`` equal;
* the reference's ``tests/test_analysis.py`` cases that need no HLO,
  restated against the port with the H100's spec;
* ``Model.init_shapes`` / ``input_specs`` / ``decode_state_specs`` on the
  meta device, for every arch's full config: shapes and dtypes leaf for
  leaf against the reference's ``jax.eval_shape``, in jax's leaf order,
  with ``kv_quant`` off and on.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.profiler import V5E as REF_V5E  # noqa: E402
from repro.launch import analytic_cost as ref_cost  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.core.profiler import H100_SXM, V5E  # noqa: E402
from repro_torch.launch.analytic_cost import cell_cost  # noqa: E402
from repro_torch.launch.roofline import (model_flops,  # noqa: E402
                                         roofline_terms)
from repro_torch.models import Model  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

FLAGS = {"REPRO_CACHE_UPDATE": "scatter", "REPRO_CHUNKED_CE": "1",
         "REPRO_CAUSAL_SKIP": "1", "REPRO_WINDOW_SLICE_DECODE": "1",
         "REPRO_KV_QUANT": "1"}
SETTINGS = {"off": {}, **{name: {name: value}
                          for name, value in FLAGS.items()}, "all": FLAGS}


def _set_flags(monkeypatch, setting: str) -> None:
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    for name, value in SETTINGS[setting].items():
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("arch", list_archs())
def test_cell_cost_matches_reference(arch, setting, monkeypatch):
    _set_flags(monkeypatch, setting)
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape_id, cell in SHAPES.items():
        for remat in (True, False):
            got = cell_cost(cfg, cell, remat=remat)
            want = ref_cost.cell_cost(rcfg, REF_SHAPES[shape_id], remat=remat)
            what = f"{arch} {shape_id} remat={remat} {setting}"
            assert got.flops == pytest.approx(want.flops, rel=1e-12), what
            assert got.bytes == pytest.approx(want.bytes, rel=1e-12), what
            assert sorted(got.detail) == sorted(want.detail), what
            for key, value in want.detail.items():
                assert got.detail[key] == pytest.approx(value, rel=1e-12), (
                    f"{what} {key}")


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_matches_reference(arch):
    for shape_id, cell in SHAPES.items():
        assert model_flops(get_config(arch), cell) == pytest.approx(
            ref_roofline.model_flops(ref_config(arch), REF_SHAPES[shape_id]),
            rel=1e-12)


@pytest.mark.parametrize("flops, bytes_, coll, chips", [
    (1e18, 1e12, 1e9, 256), (1e15, 1e13, 1e9, 256), (1e12, 1e9, 1e12, 4),
    (0.0, 0.0, 0.0, 1), (3.2e14, 6.1e11, 0.0, 1)])
def test_roofline_terms_match_reference(flops, bytes_, coll, chips):
    assert (V5E.peak_flops, V5E.hbm_bw, V5E.ici_bw) == (
        REF_V5E.peak_flops, REF_V5E.hbm_bw, REF_V5E.ici_bw)
    got = roofline_terms(flops, bytes_, coll, chips)
    want = ref_roofline.roofline_terms(flops, bytes_, coll, chips)
    assert got == want


# -- the reference's test_analysis.py cases that need no HLO, on the H100 --

def test_analytic_cost_scales_with_tokens():
    cfg = get_config("llama3.2-1b")
    train = cell_cost(cfg, SHAPES["train_4k"])
    prefill = cell_cost(cfg, SHAPES["prefill_32k"])
    decode = cell_cost(cfg, SHAPES["decode_32k"])
    assert train.flops > prefill.flops > decode.flops
    ratio = train.detail["matmul_flops"] / prefill.detail["matmul_flops"]
    assert 3.5 < ratio < 4.5
    # decode is memory-heavy: bytes/flops far above the H100's ridge point
    assert decode.bytes * H100_SXM.machine_balance > decode.flops


def test_model_flops_moe_uses_active_params():
    kimi = get_config("kimi-k2-1t-a32b")
    assert model_flops(kimi, SHAPES["train_4k"]) == (
        6.0 * kimi.n_active_params() * 256 * 4096)


def test_roofline_terms_dominance_on_the_h100():
    t = roofline_terms(flops=1e18, bytes_=1e12, coll_bytes_per_dev=1e9,
                       chips=256, hw=H100_SXM)
    assert t["dominant"] == "compute_s"
    assert t["roofline_fraction"] == 1.0
    assert t["compute_s"] == 1e18 / (256 * 989e12)
    t = roofline_terms(flops=1e15, bytes_=1e13, coll_bytes_per_dev=1e9,
                       chips=256, hw=H100_SXM)
    assert t["dominant"] == "memory_s"
    assert 0 < t["roofline_fraction"] < 1
    assert t["memory_s"] == 1e13 / (256 * 3.35e12)


def test_cache_bytes_kv_quant_halves(monkeypatch):
    cfg = get_config("deepseek-v3-671b")
    monkeypatch.setenv("REPRO_KV_QUANT", "1")
    quant = cell_cost(cfg, SHAPES["decode_32k"]).detail["cache_bytes"]
    monkeypatch.setenv("REPRO_KV_QUANT", "0")
    full = cell_cost(cfg, SHAPES["decode_32k"]).detail["cache_bytes"]
    m = cfg.mla
    assert quant / full == pytest.approx(
        (m.kv_lora_rank + 2 + 2 * m.qk_rope_head_dim)
        / (2 * (m.kv_lora_rank + m.qk_rope_head_dim)), rel=1e-12)
    assert quant < 0.6 * full


# -- dry-run specs on the meta device -----------------------------------------

def _signature(leaves) -> list[tuple[tuple[int, ...], str]]:
    out = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            assert leaf.device.type == "meta"
            out.append((tuple(leaf.shape), str(leaf.dtype).removeprefix(
                "torch.")))
        else:
            out.append((tuple(leaf.shape), np.dtype(leaf.dtype).name))
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_init_shapes_match_reference(arch):
    got = Model(get_config(arch)).init_shapes()
    want = RefModel(ref_config(arch)).init_shapes()
    assert _signature(tree_leaves(got)) == _signature(
        jax.tree_util.tree_leaves(want))


@pytest.mark.parametrize("kv_quant", ["0", "1"])
@pytest.mark.parametrize("arch", list_archs())
def test_input_and_decode_state_specs_match_reference(arch, kv_quant,
                                                      monkeypatch):
    monkeypatch.setenv("REPRO_KV_QUANT", kv_quant)
    model, ref = Model(get_config(arch)), RefModel(ref_config(arch))
    for shape_id, cell in SHAPES.items():
        got = model.input_specs(cell)
        want = ref.input_specs(REF_SHAPES[shape_id])
        assert sorted(got) == sorted(want), shape_id
        assert _signature(tree_leaves(got)) == _signature(
            jax.tree_util.tree_leaves(want)), shape_id
        if cell.step != "decode":
            continue
        got = model.decode_state_specs(cell)
        want = ref.decode_state_specs(REF_SHAPES[shape_id])
        assert _signature(tree_leaves(got)) == _signature(
            jax.tree_util.tree_leaves(want)), shape_id
        if kv_quant == "1" and model.cfg.mla is not None:
            assert {str(leaf.dtype) for leaf in tree_leaves(got)} == {
                "torch.int8", "torch.float16", "torch.bfloat16"}
