"""The benchmark's own counts against hand-worked numbers: GLM-4-9B at
batch 1 x 512, and the interval arithmetic the trace is read with."""
import pytest

from portbench import harness
from portbench.families import common, dense, hybrid
from portbench.yardstick.intervals import busy_and_overlap, gaps

GLM = harness.read_json(harness.HERE / "configs" / "glm4-9b.json")
HYMBA = harness.read_json(harness.HERE / "configs" / "hymba-1.5b.json")


def test_glm4_weight_products_at_1x512():
    # per layer: wq 4096x4096, wk and wv 4096x256, wo 4096x4096, gate and
    # up 4096x13696, down 13696x4096; 40 layers; the head 4096x151552
    per_layer_kn = (4096 * 4096 + 2 * 4096 * 256 + 4096 * 4096
                    + 3 * 4096 * 13696)
    assert per_layer_kn == 203_948_032
    kn = 40 * per_layer_kn + 4096 * 151552
    assert kn == 8_778_678_272
    products = dense.products(GLM, 1, 512)
    assert len(products) == 40 * 7 + 1
    assert all(m == 512 for _, m, _, _ in products)
    assert sum(k * n for _, _, k, n in products) == kn
    weight_flops = 2 * 512 * kn
    assert weight_flops == 8_989_366_550_528
    # attention: 512 * 513 / 2 = 131328 causal pairs, 4 * 32 heads * 128
    # a pair per layer
    attn = 40 * 4 * 32 * 131_328 * 128
    assert attn == 86_067_118_080
    assert dense.model_flops(GLM, 1, 512) == weight_flops + attn


def test_glm4_least_time_at_1x512():
    # wq: 2*512*4096*4096 = 17.18 GFLOP -> 17.37 us at 989 TFLOP/s; its
    # bytes (4096*4096 + 512*4096 + 512*4096) * 2 = 41.9 MB -> 12.52 us
    wq = [("wq", 512, 4096, 4096)]
    assert common.least_seconds(wq, "bfloat16") == pytest.approx(
        2 * 512 * 4096 * 4096 / 989e12)
    # the head at one row is bound by its bytes: 4096*151552*2 B
    head = [("head", 1, 4096, 151552)]
    assert common.least_seconds(head, "bfloat16") == pytest.approx(
        (4096 * 151552 + 4096 + 151552) * 2 / 3.35e12)
    # each product's least time is at least its operations' time, and
    # the head at M = 512 (3.8 x the bf16 ridge) is bound by them
    total = common.least_seconds(dense.products(GLM, 1, 512), "bfloat16")
    assert total >= 8_989_366_550_528 / 989e12
    assert common.least_seconds([("head", 512, 4096, 151552)],
                                "bfloat16") == pytest.approx(
        2 * 512 * 4096 * 151552 / 989e12)


def test_causal_pairs_with_windows():
    assert common.causal_pairs(4, None) == 10
    assert common.causal_pairs(4, 8) == 10
    # window 2 over 5 positions: 1 + 2 + 2 + 2 + 2
    assert common.causal_pairs(5, 2) == 9


def test_hymba_counts():
    di, n = 3200, 16
    products = hybrid.products(HYMBA, 1, 32)
    assert len(products) == 32 * 10 + 1
    names = {p[0] for p in products}
    assert {"mamba_in", "mamba_xproj", "mamba_out", "head"} <= names
    assert ("mamba_xproj", 32, di, 2 * n + 1) in products
    assert ("head", 32, 1600, 32001) in products
    flops = hybrid.model_flops(HYMBA, 1, 32)
    weights = sum(2 * m * k * nn for _, m, k, nn in products)
    attn = 32 * 4 * 25 * (32 * 33 // 2) * 64
    mixer = 32 * 32 * di * (2 * 4 + hybrid.SCAN_OPS * n)
    assert flops == weights + attn + mixer


def test_layouts_cover_the_port_tree(smoke_cfg):
    import torch
    from repro_torch.models.transformer import init_lm
    mine = harness.make_weights(smoke_cfg, 0, "cpu")
    port = init_lm(harness.port_config(smoke_cfg),
                   torch.Generator().manual_seed(0), "cpu")
    port.pop("meta", None)     # the op graph reads no meta rows

    def shapes(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from shapes(v, prefix + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from shapes(v, prefix + (i,))
        else:
            yield prefix, tuple(tree.shape), tree.dtype
    assert sorted(shapes(mine)) == sorted(shapes(port))


def test_busy_overlap_and_gaps():
    ivs = [(0, 4), (2, 6), (8, 9)]
    assert busy_and_overlap(ivs) == (7.0, 2.0)
    assert gaps(ivs, 0, 10) == [(6, 8), (9, 10)]
    assert gaps([], 1, 3) == [(1, 3)]


def test_idle_gaps_named_by_the_innermost_host_call():
    idle = harness.idle_by_host(
        [(10, 20), (30, 32)],
        [("outer", 0, 100), ("cudaGraphLaunch", 9, 21)])
    assert idle == {"cudaGraphLaunch": 10.0, "outer": 2.0}
