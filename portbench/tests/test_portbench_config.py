"""A configuration file states the port's ``ModelConfig`` whole: every
field by name, nested groups as objects, ``dtype`` by name.  The two
configurations the benchmark runs build the same program and draw the same
weights as before the file could state more, and a MoE + MLA
configuration (DeepSeek-V3's form) is taken from files alone."""
import dataclasses
import hashlib
import importlib
import json
import pathlib
import shutil
import sys

import pytest
import torch

from portbench import harness
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig, SSMConfig

ROOT = harness.HERE
HERE = pathlib.Path(__file__).resolve().parent


def _file_form(cfg: ModelConfig) -> dict:
    """``cfg`` as a configuration file states it."""
    form = dataclasses.asdict(cfg)
    form["dtype"] = str(cfg.dtype).removeprefix("torch.")
    return json.loads(json.dumps(form))


@pytest.mark.parametrize("smoke", [False, True],
                         ids=["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_port_config_round_trips(arch, smoke):
    cfg = get_config(arch, smoke=smoke)
    form = _file_form(cfg)
    form.update(norm_eps=1e-6, reduced=[], deployment="a test",
                assumed={}, not_on_path={})
    assert harness.port_config(form) == cfg


@pytest.mark.parametrize("key,group", [("n_layer", None),
                                       ("n_expert", "moe")])
def test_an_unknown_key_is_refused(key, group):
    from repro_torch.configs.deepseek_v3_671b import SMOKE
    form = _file_form(SMOKE)
    (form[group] if group else form)[key] = 4
    named = f"{group}.{key}" if group else key
    with pytest.raises(KeyError, match=rf"{named}.*"
                       r"configs/deepseek-v3-671b-smoke\.json"):
        harness.port_config(form)


# keys of DeepSeek-V3's published config.json, at the smoke widths: a
# file states its source's configuration beside the port's fields
PUBLISHED_SMOKE = {
    "hidden_size": 64, "num_hidden_layers": 4, "first_k_dense_replace": 3,
    "n_routed_experts": 8, "num_experts_per_tok": 2, "n_group": 2,
    "topk_group": 1, "routed_scaling_factor": 2.5, "q_lora_rank": 32,
    "kv_lora_rank": 16, "vocab_size": 256, "rope_theta": 10000,
    "rope_scaling": {"type": "yarn", "factor": 40},
}


def _with_published(form: dict) -> dict:
    return dict(form, **PUBLISHED_SMOKE, published=sorted(PUBLISHED_SMOKE))


def test_published_keys_stay_out_of_the_program():
    from repro_torch.configs.deepseek_v3_671b import SMOKE
    form = _with_published(_file_form(SMOKE))
    assert harness.port_config(form) == SMOKE
    # "vocab_size" and "rope_theta" are published and fields: passed on
    form.update(vocab_size=512, rope_theta=5e5)
    assert harness.port_config(form) == dataclasses.replace(
        SMOKE, vocab_size=512, rope_theta=5e5)
    form["published"].remove("n_group")
    with pytest.raises(KeyError, match="n_group"):
        harness.port_config(form)


# what port_config built from each configuration file before a file could
# state every field
PARENT_CONFIGS = {
    "glm4-9b": ModelConfig(
        name="glm4-9b", family="dense", n_layers=40, d_model=4096,
        n_heads=32, n_kv_heads=2, d_ff=13696, vocab_size=151552, d_head=128,
        qkv_bias=True, norm="rmsnorm", tie_embeddings=False, window=None,
        global_layers=(), meta_tokens=0, ssm=None, dtype=torch.bfloat16,
        source="https://huggingface.co/THUDM/glm-4-9b"),
    "hymba-1.5b": ModelConfig(
        name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
        n_heads=25, n_kv_heads=5, d_ff=5504, vocab_size=32001, d_head=64,
        qkv_bias=False, norm="rmsnorm", tie_embeddings=True, window=1024,
        global_layers=(0, 15, 31), meta_tokens=128,
        ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
        dtype=torch.bfloat16, source="https://arxiv.org/abs/2411.13676"),
}


@pytest.mark.parametrize("name", sorted(PARENT_CONFIGS))
def test_the_cells_build_the_parents_model_config(name):
    cfg = harness.read_json(ROOT / "configs" / f"{name}.json")
    assert harness.port_config(cfg) == PARENT_CONFIGS[name]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _digest(tree) -> str:
    h = hashlib.sha256()
    for path, t in sorted(_leaves(tree), key=lambda x: repr(x[0])):
        h.update(repr((path, tuple(t.shape), str(t.dtype))).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


# make_weights(SMOKE[family], 0, "cpu") before a family could name a
# leaf's dtype
PARENT_DIGESTS = {
    "dense": "08f63e0770b181069d65634acde41e19"
             "b90c55b6f69ad524f77639caa66aa55f",
    "hybrid": "2caff458f9e98202d8c7a951a75da4c0"
              "c2018561d24e8407ec9e5a151b092100",
}


def test_the_families_draw_the_parents_weights(smoke_cfg):
    digest = _digest(harness.make_weights(smoke_cfg, 0, "cpu"))
    assert digest == PARENT_DIGESTS[smoke_cfg["family"]]


# -- a MoE + MLA configuration taken from files alone ------------------------

def _paths_shapes_dtypes(tree) -> list:
    return sorted((p, tuple(t.shape), t.dtype) for p, t in _leaves(tree))


@pytest.fixture
def moe_copy(tmp_path, monkeypatch):
    """A copy of the benchmark with DeepSeek-V3's smoke configuration, a
    test-only ``families/moe.py``, a traffic mix and a cell dropped in;
    ``portbench.families`` reads the copy's folder first.  Yields the
    cell."""
    from repro_torch.configs.deepseek_v3_671b import SMOKE
    copy = tmp_path / "portbench"
    shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
        "__pycache__"))
    cfg = dict(_with_published(_file_form(SMOKE)), norm_eps=1e-6,
               reduced=[])
    (copy / "configs" / f"{SMOKE.name}.json").write_text(json.dumps(cfg))
    shutil.copy(HERE / "moe_family.py", copy / "families" / "moe.py")
    traffic = harness.read_json(copy / "traffic" / "b1s32.json")
    traffic.update(seq=16)
    (copy / "traffic" / "b1s16.json").write_text(json.dumps(traffic))
    cell = f"{SMOKE.name}.b1s16"
    (copy / "workloads" / f"{cell}.json").write_text(json.dumps(
        {"config": SMOKE.name, "traffic": "b1s16", "why": "test",
         "limits": {"row_rel_l2": 0.1, "pos_rel_l2": 0.1}}))
    m = harness.manifest()
    m["workloads"].append({"name": cell, "config": SMOKE.name,
                           "traffic": "b1s16", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    families = importlib.import_module("portbench.families")
    monkeypatch.setattr(families, "__path__",
                        [str(copy / "families")] + list(families.__path__))
    yield harness.load_cell(cell, root=copy)
    sys.modules.pop("portbench.families.moe", None)


def test_a_moe_mla_config_draws_the_port_layout(moe_copy):
    from repro_torch.models.transformer import init_lm
    cfg = moe_copy.cfg
    assert not (ROOT / "families" / "moe.py").exists()
    mine = harness.make_weights(cfg, 2 ** 31 + 5, "cpu")
    port = init_lm(harness.port_config(cfg),
                   torch.Generator().manual_seed(0), "cpu")
    assert _paths_shapes_dtypes(mine) == _paths_shapes_dtypes(port)
    router = mine["stacks"][1]["ffn"]["router"]
    assert router["w"].dtype == router["bias"].dtype == torch.float32
    assert mine["stacks"][1]["ffn"]["experts"]["gate"].dtype == \
        torch.bfloat16


def test_a_moe_mla_config_compiles_and_runs(moe_copy):
    from repro_torch.core.graph import OpKind
    cfg, traffic = moe_copy.cfg, moe_copy.traffic
    b, s = traffic["batch"], traffic["seq"]
    weights = harness.make_weights(cfg, 2 ** 31 + 7, "cpu")
    pool = harness.make_pool(cfg, traffic, 2 ** 31 + 7, "cpu")
    graph, model = harness.compile_program(cfg, weights, b, s, pool[0],
                                           "cpu")
    names = {n.name for n in graph}
    # MLA's down-projections, in every layer
    for li in range(cfg["n_layers"]):
        assert {f"L{li}.wq_a", f"L{li}.wkv_a"} <= names
    # routed experts behind a router, past the dense first three layers
    assert {"L3.router", "L3.expert0_in", "L3.expert0_down",
            "L3.shared_in", "L3.combine"} <= names
    assert not any(n.startswith("L2.router") for n in names)
    assert any(n.kind == OpKind.GEMM and ".expert" in n.name
               for n in graph)
    logits = model({"tokens": pool[1]})[-1]
    assert logits.shape == (b, s, cfg["vocab_size"]) and b == 1
    assert bool(torch.isfinite(logits).all())
