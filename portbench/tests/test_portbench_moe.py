"""The DeepSeek-V3 configuration of the benchmark (family ``moe``): its
file builds the port's model at the chip's share, a smoke-sized twin
draws the port's ``init_lm`` tree, and the counts behind the held
experts' roofline and ``expert_ms`` against hand-worked numbers."""
import pytest
import torch

from portbench import harness
from portbench.families import moe
from portbench.metrics import expert_ms

CFG = harness.read_json(harness.HERE / "configs" / "deepseek-v3-671b.json")
PEAKS = harness.read_json(harness.HERE / "yardstick" / "peaks.json")


def _smoke() -> dict:
    """The file's twin at smoke widths: the same keys, 2 dense + 3 MoE
    layers, 4 held of 16 experts."""
    c = {k: v for k, v in CFG.items() if k in ("rope_theta", "vocab_size")
         or (k not in CFG["published"] and k != "published")}
    c.update(name="deepseek-v3-671b-smoke", n_layers=5, d_model=64,
             n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256)
    c["mla"] = dict(c["mla"], q_lora_rank=32, kv_lora_rank=16,
                    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    c["moe"] = dict(c["moe"], n_experts=16, top_k=4, d_expert=32, n_group=4,
                    topk_group=2, held_experts=4, expert_rank=3,
                    dense_prefix=2)
    return c


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tuple(tree.shape), tree.dtype


def test_make_weights_is_the_port_init_lm_tree():
    from repro_torch.models.transformer import init_lm
    cfg = _smoke()
    mine = harness.make_weights(cfg, 2 ** 31 + 3, "cpu")
    port = init_lm(harness.port_config(cfg),
                   torch.Generator().manual_seed(0), "cpu")
    assert sorted(_leaves(mine)) == sorted(_leaves(port))
    ffn = mine["stacks"][1]["ffn"]
    assert ffn["router"]["w"].dtype == ffn["router"]["bias"].dtype == \
        torch.float32
    assert tuple(ffn["router"]["w"].shape) == (3, 64, 16)
    assert tuple(ffn["experts"]["down"].shape) == (3, 4, 32, 64)
    assert ffn["experts"]["gate"].dtype == torch.bfloat16
    # the balancing bias is drawn, not zero: the routing has to use it
    assert float(ffn["router"]["bias"].abs().sum()) > 0


def test_the_file_states_the_published_widths_and_the_cut():
    cfg = harness.port_config(CFG)
    assert (cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.moe.d_expert,
            cfg.moe.n_experts, cfg.moe.top_k, cfg.mla.q_lora_rank,
            cfg.mla.kv_lora_rank, cfg.mla.qk_nope_head_dim,
            cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim) == (
        7168, 18432, 129280, 2048, 256, 8, 1536, 512, 128, 64, 128)
    assert sorted(CFG["reduced"]) == sorted(
        ["num_hidden_layers", "num_attention_heads", "num_key_value_heads",
         "n_routed_experts"])
    assert {k: v["published"] for k, v in CFG["reduced"].items()} == {
        "num_hidden_layers": 61, "num_attention_heads": 128,
        "num_key_value_heads": 128, "n_routed_experts": 256}
    assert (cfg.n_layers, cfg.n_heads, cfg.moe.held_experts) == (31, 32, 8)
    manifest = harness.manifest()
    entry = next(c for c in manifest["configs"]
                 if c["name"] == "deepseek-v3-671b")
    assert sorted(entry["reduced"]) == sorted(CFG["reduced"])


def test_expert_mlp_counts_by_hand():
    # 28 MoE layers; 512 tokens x top-8 x 8 held / 256 = 128 routed rows a
    # layer, 16 an expert; weights 8 experts x 3 x 7168 x 2048 x 2 B =
    # 704.6 MB a layer
    assert moe.moe_layers(CFG) == 28
    assert moe.routed_rows(CFG, 512) == 128
    expected = moe.expected_counts(CFG, 1, 512)
    assert expected == [[16.0] * 8] * 28
    work = moe.expert_mlp_work(CFG, expected)
    assert work[0] == (2 * 128 * 7168 * 2048 * 3,
                       2 * (8 * 3 * 7168 * 2048 + 2 * 128 * 7168))
    # bound by the bytes: 28 x 708.3 MB / 3.35 TB/s = 5.920 ms a forward
    least = moe.expert_mlp_least_seconds(CFG, expected, PEAKS)
    assert least == pytest.approx(28 * work[0][1] / 3.35e12)
    assert least == pytest.approx(5.920e-3, rel=1e-3)
    # an expert with no row reads no weight; 504 rows on one expert are
    # bound by their operations (44.4 GFLOP, 44.9 us; its weights 26.3 us)
    skewed = [[504, 0, 0, 0, 0, 0, 0, 0]]
    (flops, nbytes), = moe.expert_mlp_work(CFG, skewed)
    assert nbytes == 2 * (3 * 7168 * 2048 + 2 * 504 * 7168)
    assert moe.expert_mlp_least_seconds(CFG, skewed, PEAKS) == \
        pytest.approx(flops / 989e12)
    assert moe.expert_mlp_least_seconds(CFG, [[0] * 8], PEAKS) == 0
    # the held experts' products sum to the same operations
    layer = moe.expert_products(CFG, 512)
    assert len(layer) == 24
    assert sum(2 * m * k * n for _, m, k, n in layer) == work[0][0]


def test_expert_ms_reads_the_moe_kernels_only():
    ctx = {"cfg": CFG, "batch": 1, "seq": 512, "family": moe,
           "peaks": PEAKS, "trace": {"device_ops": [
               ["void cutlass::Kernel2<cutlass_80_simt_sgemm>", 7e-3],
               ["void (anonymous namespace)::wg::expert_wgmma_kernel<true, "
                "64>(CUtensorMap_st, CUtensorMap_st)", 4.5e-3],
               ["nvjet_tst_256x128_64x4_2x4_h_bz_coopA_NNT", 2e-3],
               ["void (anonymous namespace)::wg::expert_wgmma_kernel<false, "
                "64>(CUtensorMap_st, CUtensorMap_st)", 2e-3]]}}
    # both stages of the wgmma route
    assert expert_ms.read(ctx) == pytest.approx(6.5)
    # a stage past the harness's ten largest operations is not counted
    ctx["trace"]["device_ops"] = ctx["trace"]["device_ops"][:3]
    assert expert_ms.read(ctx) == pytest.approx(4.5)
    ctx["trace"]["device_ops"] = ctx["trace"]["device_ops"][::2]
    assert expert_ms.read(ctx) is None
    ctx["trace"] = None
    assert expert_ms.read(ctx) is None


def test_model_flops_at_the_chips_share():
    products = moe.products(CFG, 1, 512)
    # attention 3 + 32 + 32 + 1 products a layer (the low-rank pair and
    # wkv_a, wk_b and wv_b per head, wo); 3 dense layers with their 3 MLP
    # products, 28 MoE layers with the router, 8 held experts' 3 and the
    # shared expert's 3; the head
    assert len(products) == 3 * (68 + 3) + 28 * (68 + 1 + 24 + 3) + 1
    pairs = 512 * 513 // 2
    attn = 31 * 2 * 32 * pairs * (192 + 128)
    weights = sum(2 * m * k * n for _, m, k, n in products)
    assert moe.model_flops(CFG, 1, 512) == weights + attn
