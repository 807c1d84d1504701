"""DeepSeek-V3 as one chip of its expert-parallel deployment, on the CPU:
the one routing rule (noaux_tc: sigmoid scores, a selection-only bias, a
group limit, the routed scale), the expert-parallel MoE layer (a chip's
held experts, routing over all of them, no pair dropped), YaRN in MLA, the
op graph against the benchmark's plain reference, the program's counter of
routed pairs, and the cost-only graphs of the benchmark's other cells,
which this layer must leave as they were.

Tolerances: float32 against float32 1e-5 (summation order only); the
routing compared exactly (indices) where the scores are drawn apart."""
import dataclasses
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.reference.common import logits as ref_logits  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    MLAConfig, ModelConfig, MoEConfig, YaRNConfig)
from repro_torch.models.attention import _mla_scale  # noqa: E402
from repro_torch.models.ffn import (  # noqa: E402
    held_combine, held_dispatch, held_mlp, held_plan, init_moe,
    moe_ffn_dense, moe_ffn_held, route, select_experts)
from repro_torch.models.layers import (  # noqa: E402
    rope_freqs, yarn_correction_range, yarn_mscale)
from repro_torch.models.opgraph_export import build_lm_opgraph  # noqa: E402
from repro_torch.models.transformer import init_lm  # noqa: E402

E_SMALL = MoEConfig(n_experts=32, top_k=4, d_expert=8, router_aux_free=True,
                    n_group=4, topk_group=2, routed_scaling_factor=2.5)


# -- the routing rule ------------------------------------------------------------

def _noaux_tc(logits: np.ndarray, bias: np.ndarray, e) -> list:
    """DeepSeek-V3's noaux_tc written out token by token: sigmoid scores;
    each group of E / n_group experts scores the sum of its two best
    biased scores; the top_k biased scores inside the topk_group best
    groups; weights the unbiased scores, normalised, times the scale.
    → per token, sorted [(expert, weight)]."""
    out = []
    size = logits.shape[1] // e.n_group
    for row in logits:
        scores = 1 / (1 + np.exp(-row.astype(np.float64)))
        biased = scores + bias
        groups = [sorted(biased[g * size:(g + 1) * size])[-2:]
                  for g in range(e.n_group)]
        best = sorted(range(e.n_group), key=lambda g: -sum(groups[g]))
        allowed = [j for g in best[:e.topk_group]
                   for j in range(g * size, (g + 1) * size)]
        chosen = sorted(allowed, key=lambda j: -biased[j])[:e.top_k]
        total = sum(scores[j] for j in chosen)
        out.append(sorted((j, scores[j] / total * e.routed_scaling_factor)
                          for j in chosen))
    return out


def test_routing_rule_is_noaux_tc():
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(64, E_SMALL.n_experts, generator=g)
    bias = torch.randn(E_SMALL.n_experts, generator=g) * 0.3
    _, w, idx = select_experts(logits, bias, E_SMALL)
    want = _noaux_tc(logits.numpy(), bias.numpy(), E_SMALL)
    for n, pairs in enumerate(want):
        got = sorted(zip(idx[n].tolist(), w[n].tolist()))
        assert [j for j, _ in got] == [j for j, _ in pairs]
        np.testing.assert_allclose([x for _, x in got],
                                   [x for _, x in pairs], rtol=1e-5)
    # the group limit bites: no token takes an expert from more than
    # topk_group groups, and some token would have without it
    groups = idx // (E_SMALL.n_experts // E_SMALL.n_group)
    assert max(len(set(r)) for r in groups.tolist()) <= E_SMALL.topk_group
    free = dataclasses.replace(E_SMALL, n_group=1, topk_group=1)
    free_groups = select_experts(logits, bias, free)[2] // 8
    assert max(len(set(r)) for r in free_groups.tolist()) > 2


def _parent_route(p_router, x, e, generator=None):
    """The routing of the parent commit's ``ffn.route``."""
    logits = x.float() @ p_router["w"]
    scores = (torch.sigmoid(logits) if e.router_aux_free
              else torch.softmax(logits, dim=-1))
    select = scores + p_router["bias"][None, :] if e.router_aux_free \
        else scores
    if generator is not None and e.router_noise > 0:
        select = select + torch.randn(select.shape, generator=generator,
                                      device=select.device) * e.router_noise
    top_idx = torch.topk(select, e.top_k, dim=-1).indices
    top_w = torch.gather(scores, -1, top_idx)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_idx


@pytest.mark.parametrize("aux_free,noise", [(True, 0.0), (False, 0.0),
                                            (True, 0.5)])
def test_routing_rule_at_the_defaults_is_the_parents(aux_free, noise):
    e = MoEConfig(n_experts=16, top_k=3, d_expert=8,
                  router_aux_free=aux_free, router_noise=noise)
    g = torch.Generator().manual_seed(5)
    p = {"w": torch.randn(24, 16, generator=g),
         "bias": torch.randn(16, generator=g) * 0.2}
    x = torch.randn(40, 24, generator=g)
    w, idx, _ = route(p, x, e, torch.Generator().manual_seed(9))
    w0, idx0 = _parent_route(p, x, e, torch.Generator().manual_seed(9))
    assert torch.equal(idx, idx0) and torch.equal(w, w0)


# -- the expert-parallel layer ------------------------------------------------------

def _moe_cfg(n_experts=8, top_k=3, held=0, rank=0, n_shared=1, **kw):
    moe = MoEConfig(n_experts=n_experts, top_k=top_k, d_expert=16,
                    n_shared=n_shared, router_aux_free=True,
                    held_experts=held, expert_rank=rank, **kw)
    return ModelConfig(name="ep-test", family="moe", n_layers=2, d_model=32,
                       n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                       moe=moe, dtype=torch.float32)


def _moe_params(cfg, seed=0):
    p = init_moe(torch.Generator().manual_seed(seed), cfg, device="cpu")
    p["router"]["bias"] = torch.randn(
        cfg.moe.n_experts, generator=torch.Generator().manual_seed(seed + 1)
    ) * 0.1
    return p


def _share(p: dict, first: int, held: int) -> dict:
    return {"router": p["router"],
            "experts": {k: v[first:first + held]
                        for k, v in p["experts"].items()}}


def test_held_shares_add_up_to_the_uncut_layer():
    """Every chip's held part, for all E / held shares, plus the shared
    expert counted once, equals the uncut layer; and the uncut dropless
    layer equals the capacity-buffer layer whose capacity drops nothing."""
    uncut_cfg = _moe_cfg(held=8, n_group=2, topk_group=1,
                         routed_scaling_factor=2.5)
    p = _moe_params(uncut_cfg)
    x = torch.randn(2, 12, 32, generator=torch.Generator().manual_seed(2))
    uncut, _ = moe_ffn_held(p, x, uncut_cfg)
    no_shared = dataclasses.replace(
        uncut_cfg, moe=dataclasses.replace(uncut_cfg.moe, n_shared=0))
    total = moe_ffn_held(p, x, no_shared)[0] * 0
    for rank in range(4):
        cfg = dataclasses.replace(no_shared, moe=dataclasses.replace(
            no_shared.moe, held_experts=2, expert_rank=rank))
        total = total + moe_ffn_held(_share(p, 2 * rank, 2), x, cfg)[0]
    shared_cfg = dataclasses.replace(
        no_shared, moe=dataclasses.replace(no_shared.moe, n_shared=1))
    shared_only = moe_ffn_held(p, x, shared_cfg)[0] - moe_ffn_held(
        p, x, no_shared)[0]
    torch.testing.assert_close(total + shared_only, uncut, rtol=1e-5,
                               atol=1e-5)
    # the capacity-buffer layer, its capacity every token an expert
    capped = dataclasses.replace(uncut_cfg, moe=dataclasses.replace(
        uncut_cfg.moe, held_experts=0, capacity_factor=8 / 3))
    dense, _ = moe_ffn_dense(p, x, capped)
    torch.testing.assert_close(uncut, dense, rtol=1e-5, atol=1e-5)


def test_dropless_every_token_to_one_held_expert():
    """A bias that sends every token to expert 5 (held by rank 1 of 2)
    fills its buffer to the last row: no pair is lost, and the layer is
    that expert's MLP of every token times its weight."""
    cfg = _moe_cfg(n_experts=8, top_k=2, held=4, rank=1, n_shared=0)
    p = _moe_params(_moe_cfg(n_experts=8, top_k=2, n_shared=0))
    p["router"]["bias"] = torch.full((8,), -10.0)
    p["router"]["bias"][5] = 10.0        # every token's first choice
    p["router"]["bias"][0] = 5.0         # and second, on the other rank
    p = _share(p, 4, 4)
    x = torch.randn(3, 7, 32, generator=torch.Generator().manual_seed(4))
    xf = x.reshape(21, 32)
    w, idx, _ = route(p["router"], xf, cfg.moe)
    assert set(idx[:, 0].tolist()) == {5} and set(idx[:, 1].tolist()) == {0}
    plan = held_plan(idx, 4, 4)
    assert plan[:, -1].tolist() == [0, 21, 0, 0]
    assert plan[1, :-1].tolist() == list(range(21))
    y, _ = moe_ffn_held(p, x, cfg)
    ex = {k: v[1] for k, v in p["experts"].items()}
    h = torch.nn.functional.silu(xf @ ex["gate"]) * (xf @ ex["up"])
    want = w[:, :1] * (h @ ex["down"])
    torch.testing.assert_close(y.reshape(21, 32), want, rtol=1e-5,
                               atol=1e-5)


def test_held_layer_pieces_leave_unrouted_rows_out():
    """The combine reads a held expert's row only for a token routed to
    it: rows past a count may hold anything (NaN here)."""
    cfg = _moe_cfg(held=4, rank=0, n_shared=0)
    p = _moe_params(cfg)
    xf = torch.randn(10, 32, generator=torch.Generator().manual_seed(6))
    w, idx, _ = route(p["router"], xf, cfg.moe)
    plan = held_plan(idx, 0, 4)
    out = held_mlp(p["experts"], held_dispatch(xf, plan),
                   plan[:, -1].to(torch.int32), use_kernels=True)
    clean = held_combine(out, w, idx, plan, 0, 4)
    rows = out[:-1].view(4, 10, 32)
    for j, count in enumerate(plan[:, -1].tolist()):
        rows[j, count:] = float("nan")
    assert torch.equal(held_combine(out, w, idx, plan, 0, 4), clean)
    assert bool(torch.isfinite(clean).all())


# -- YaRN -------------------------------------------------------------------------

DS_YARN = YaRNConfig(factor=40, original_max_position_embeddings=4096,
                     beta_fast=32, beta_slow=1, mscale=1.0,
                     mscale_all_dim=1.0)


def test_yarn_frequencies_and_mscale_follow_the_formulas():
    d, theta = 64, 1e4
    # the dims that turn 32 and 1 times over 4096 positions
    corr = [d * math.log(4096 / (r * 2 * math.pi)) / (2 * math.log(theta))
            for r in (32, 1)]
    low, high = math.floor(corr[0]), math.ceil(corr[1])
    assert yarn_correction_range(32, 1, d, theta, 4096) == (low, high)
    assert (low, high) == (10, 23)
    base = [theta ** (-2 * i / d) for i in range(d // 2)]
    want = []
    for i, f in enumerate(base):
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(f / 40 * ramp + f * (1 - ramp))
    got = rope_freqs(d, theta, "cpu", DS_YARN)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert got[0] == pytest.approx(1.0) and got[-1] == pytest.approx(
        base[-1] / 40, rel=1e-6)
    assert torch.equal(rope_freqs(d, theta, "cpu"),
                       rope_freqs(d, theta, "cpu", None))
    # mscale² ≈ 1.874 on the softmax scale, cos / sin unscaled (1 / 1)
    assert yarn_mscale(40, 1.0) == pytest.approx(0.1 * math.log(40) + 1)
    assert yarn_mscale(40, 1.0) ** 2 == pytest.approx(1.8738, abs=1e-4)
    assert yarn_mscale(1.0, 1.0) == 1.0
    cfg = get_config("deepseek-v3-671b")
    assert _mla_scale(cfg) == 192 ** -0.5
    yarn = dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, rope_scaling=DS_YARN))
    assert _mla_scale(yarn) == pytest.approx(
        192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2)


# -- the op graph against the benchmark's plain reference -------------------------

def _smoke_file(dtype: str = "float32", rank: int = 1) -> dict:
    """The benchmark's DeepSeek-V3 configuration file at smoke widths: the
    same keys, a 2 + 3 layer stack, 16 experts of which 4 are held."""
    c = harness.read_json(harness.HERE / "configs" / "deepseek-v3-671b.json")
    keep = {"rope_theta", "vocab_size"}
    c = {k: v for k, v in c.items()
         if k in keep or (k not in c["published"] and k != "published")}
    c.update(name="deepseek-v3-671b-smoke", dtype=dtype, n_layers=5,
             d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
             max_seq_len=128)
    c["mla"] = dict(c["mla"], q_lora_rank=32, kv_lora_rank=16,
                    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                    rope_scaling=dict(c["mla"]["rope_scaling"],
                                      original_max_position_embeddings=8))
    c["moe"] = dict(c["moe"], n_experts=16, top_k=4, d_expert=32, n_group=4,
                    topk_group=2, held_experts=4, expert_rank=rank,
                    dense_prefix=2)
    return c


def _program(cfg, weights, ids):
    graph, model = harness.compile_program(cfg, weights, ids.shape[0],
                                           ids.shape[1], ids, "cpu")
    return graph, model({"tokens": ids})[-1]


@pytest.fixture
def calib_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "BUILD", tmp_path / "build")


def test_op_graph_equals_the_plain_reference(calib_in_tmp):
    cfg = _smoke_file("float32")
    weights = harness.make_weights(cfg, 2 ** 31 + 11, "cpu")
    ids = torch.randint(0, 256, (2, 20),
                        generator=torch.Generator().manual_seed(1))
    graph, got = _program(cfg, weights, ids)
    names = {n.name for n in graph}
    assert {"L2.router", "L2.route", "L2.plan", "L2.dispatch",
            "L2.experts", "L2.combine", "L2.shared_in",
            "L2.moe_out"} <= names
    assert not any(n.startswith("L1.router") for n in names)
    assert not any(".expert0" in n for n in names)
    checks = harness.compare(cfg, weights, ids, got)
    assert checks["pos_rel_l2"] < 1e-5, checks
    # bf16: within rounding, the fp8 control well outside
    cfg = _smoke_file("bfloat16")
    weights = harness.make_weights(cfg, 2 ** 31 + 11, "cpu")
    program = harness.compare(cfg, weights, ids,
                              _program(cfg, weights, ids)[1])
    ref = harness.reference_module(cfg)
    control = torch.stack([ref_logits(cfg, weights, h, "fp8")
                           for h in ref.hidden(cfg, weights, ids, "fp8")])
    against = harness.compare(cfg, weights, ids, control)
    assert program["row_rel_l2"] < 0.05, program
    for k in program:
        assert against[k] > 3 * program[k], (k, program, against)


def test_the_layout_and_the_counter_of_held_pairs(calib_in_tmp):
    """The file's weights are the port's ``init_lm`` tree (router in
    float32, the held experts only), and with tracing on each forward's
    walk reads the routed pairs of every MoE layer's held experts."""
    cfg = _smoke_file("bfloat16", rank=2)
    port_cfg = harness.port_config(cfg)
    weights = harness.make_weights(cfg, 7, "cpu")
    port = init_lm(port_cfg, torch.Generator().manual_seed(0), "cpu")

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, prefix + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, prefix + (i,))
        else:
            yield prefix, tuple(tree.shape), tree.dtype
    assert sorted(leaves(weights)) == sorted(leaves(port))
    ffn = weights["stacks"][1]["ffn"]
    assert ffn["router"]["w"].dtype == torch.float32
    assert tuple(ffn["experts"]["gate"].shape) == (3, 4, 64, 32)
    ids = torch.randint(0, 256, (1, 24),
                        generator=torch.Generator().manual_seed(2))
    trace.reset()
    trace.enable()
    try:
        _, model = harness.compile_program(cfg, weights, 1, 24, ids, "cpu")
        model({"tokens": ids})
        walks = [s for s in trace.records() if s.name == "walk"]
        meta = trace.counter_meta()["moe.held_counts"]
    finally:
        trace.enable(False)
        trace.reset()
    counts = torch.tensor(walks[-1].counters["moe.held_counts"])
    assert counts.shape == (3, 4) and meta["capacity"] == 24
    assert meta["experts"] == (8, 4)
    # the same pairs the routing rule gives, layer by layer
    assert int(counts.sum()) > 0
    assert int(counts.max()) <= 24


# -- the benchmark's other cells keep their graphs ---------------------------------

# signature_digest() of the cost-only graphs at the parent commit
PARENT_DIGESTS = {
    ("glm4-9b", 1): "b74a61c90ad417475390b7e6138fd883162a26ba",
    ("glm4-9b", 8): "25ec3f0f15b56ccf084e1ea7f00737a133dceec4",
    ("hymba-1.5b", 1): "69acce1475a87a28a5d4ce2ec9957197d969d222",
    ("hymba-1.5b", 8): "9c744b6406a271036ba721fab9d22fcb9217c7a1",
}
PARENT_SMOKE_DIGESTS = {
    "deepseek-v3-671b": ("3d66d8ac9f88cb95572169cc3961bc21bf127485",
                         "d25a994bf7d0ced69162105fe65dabd7f859ea93"),
    "kimi-k2-1t-a32b": ("ac30f6b304907cbc9431419d8819b0f2deddf37a",
                        "88d4aa25f6129d6958fbb702eeeff64498e3396a"),
}


@pytest.mark.parametrize("name,batch", sorted(PARENT_DIGESTS))
def test_the_cells_cost_only_graphs_are_the_parents(name, batch):
    cfg = harness.port_config(harness.read_json(
        harness.HERE / "configs" / f"{name}.json"))
    graph = build_lm_opgraph(cfg, batch, 512)
    assert graph.signature_digest() == PARENT_DIGESTS[(name, batch)]


@pytest.mark.parametrize("arch", sorted(PARENT_SMOKE_DIGESTS))
def test_moe_smoke_graphs_are_the_parents(arch):
    """Configs that set none of the new fields export the same graphs,
    routed (with weights) and cost-only."""
    cfg = get_config(arch, smoke=True)
    params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    routed = build_lm_opgraph(cfg, 2, 16, params).signature_digest()
    cost = build_lm_opgraph(cfg, 2, 16).signature_digest()
    assert (routed, cost) == PARENT_SMOKE_DIGESTS[arch]


def test_full_width_config_builds_the_published_model():
    """The benchmark's file builds DeepSeek-V3's published widths at this
    chip's share, and its cost-only graph routes over all 256 experts."""
    cfg = harness.port_config(harness.read_json(
        harness.HERE / "configs" / "deepseek-v3-671b.json"))
    assert isinstance(cfg.mla, MLAConfig) and cfg.mla.rope_scaling == DS_YARN
    assert (cfg.n_layers, cfg.n_heads, cfg.moe.n_experts,
            cfg.moe.held_experts, cfg.moe.top_k, cfg.moe.n_group,
            cfg.moe.topk_group, cfg.moe.routed_scaling_factor,
            cfg.moe.dense_prefix) == (31, 32, 256, 8, 8, 8, 4, 2.5, 3)
    graph = build_lm_opgraph(cfg, 1, 512)
    router = next(n for n in graph if n.name == "L3.router")
    assert router.out_shape == (1, 512, 256)
    assert next(n for n in graph if n.name == "L3.dispatch").out_shape == (
        8, 512, 7168)
    assert sum(n.name.endswith(".experts") for n in graph) == 28


def test_the_trace_cell_script_reads_the_held_counts(monkeypatch, tmp_path):
    """``scripts/torch_trace_cell.py`` on the smoke-sized DeepSeek-V3 cell
    on the CPU: every window forward reads ``moe.held_counts``, the routed
    pairs to the held experts, and the run stays correct."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_trace_cell", ROOT / "scripts" / "torch_trace_cell.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(script.harness, "BUILD", tmp_path / "build")
    traffic = {"loop": "closed", "clients": 1, "batch": 1, "seq": 16,
               "pool": 8, "sample": 1, "sample_from": 1, "warmup": 1,
               "trace_seconds": 0.05, "warmup_seconds": 0.05}
    m = harness.manifest()
    cell = harness.Cell("smoke", _smoke_file("bfloat16"), traffic,
                        {"row_rel_l2": 0.2, "pos_rel_l2": 0.4},
                        m["end_to_end"], m["per_layer"])
    result, report = script.trace_cell(cell, 2 ** 31 + 9, 0.3, "cpu")
    assert result["correct"] is True, result["checks"]
    held = report["counters"]["moe.held_counts"]
    assert held["forwards"] == report["metrics"]["forwards"] >= 1
    assert held["capacity"] == 16 and held["experts"] == (4, 4)
    assert held["sum_expected"] == 3 * 16 * 4 * 4 / 16
    assert 0 < held["sum_min"] <= held["sum_max"] <= 3 * 16 * 4
    assert held["largest"] <= 16
    # no moe_gemm kernel on the CPU: no device time to hold the counts to
    assert report["expert_roofline"] is None or \
        report["expert_roofline"]["value"] is None
    assert not trace.on and trace.records() == []
