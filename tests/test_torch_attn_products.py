"""The op graph's two attention products (``scores`` = QKᵀ, ``ctx`` = PV).

Two bf16 operands on a CUDA device take a tensor-core batched GEMM with an
fp32 result; every other pair runs the fp32 einsum, so the CPU reads the
same numbers as before bit for bit.  The card's route cannot run here
(``bmm(out_dtype=)`` has no CPU kernel): its layout is checked by standing
an fp32 ``bmm`` in for the card's product.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import opgraph_export as ox  # noqa: E402

B, S = 2, 8
# (KV heads, query heads a KV head, Dk, Dv, V a strided slice of K)
SHAPES = {"glm4": (2, 16, 128, 128, False), "hymba": (5, 5, 64, 64, False),
          "mla": (1, 32, 576, 512, True)}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _heads(gen, b, h, t, d, dtype):
    """Head-major ``[b, h, t, d]`` as the graph has it: a permuted view of
    the projection's ``[b, t, h·d]`` output."""
    x = torch.randn(b, t, h * d, generator=gen).to(dtype)
    return x.reshape(b, t, h, d).permute(0, 2, 1, 3)


def _operands(shape: str, dtype, seed: int = 0):
    kvh, g, dk, dv, latent = SHAPES[shape]
    gen = torch.Generator().manual_seed(seed)
    q = _heads(gen, B, kvh * g, S, dk, dtype)
    if latent:   # MLA: one latent head [B,1,T,rank+rope], V its first rank
        k = torch.randn(B, S, dk, generator=gen).to(dtype)[:, None]
        v = k[..., :dv]
    else:
        k = _heads(gen, B, kvh, S, dk, dtype)
        v = _heads(gen, B, kvh, S, dv, dtype)
    p = torch.softmax(torch.randn(B, kvh * g, S, S, generator=gen), -1)
    return q, k, v, p


def _scores_einsum(q, k):
    b, nh, s, hd = q.shape
    kvh, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, nh // kvh, s, hd)
    return torch.einsum("bkgsd,bktd->bkgst", qg.float(),
                        k.float()).reshape(b, nh, s, t)


def _ctx_einsum(p, v):
    b, nh, s, t = p.shape
    kvh, dv = v.shape[1], v.shape[-1]
    pg = p.reshape(b, kvh, nh // kvh, s, t).to(v.dtype)
    out = torch.einsum("bkgst,bktd->bkgsd", pg.float(), v.float())
    return out.reshape(b, nh, s, dv).to(v.dtype)


@pytest.fixture
def card_route(monkeypatch):
    """The card's route on the CPU: every pair routed to it, the product an
    fp32 ``bmm`` over the operands as given; records each product's
    operands."""
    seen = []

    def bmm(a, b):
        seen.append((a, b))
        return torch.bmm(a.float(), b.float())
    monkeypatch.setattr(ox, "tc_route", lambda *_: True)
    monkeypatch.setattr(ox, "_bmm_f32", bmm)
    return seen


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cpu_route_equals_the_fp32_einsum_bit_for_bit(shape, dtype):
    q, k, v, p = _operands(shape, DTYPES[dtype])
    before = ox.attn_tc_products
    scores = ox._scores_payload(q, k)
    ctx = ox._ctx_payload(p, v)
    assert scores.dtype == torch.float32 and ctx.dtype == v.dtype
    assert torch.equal(scores, _scores_einsum(q, k))
    assert torch.equal(ctx, _ctx_einsum(p, v))
    assert ox.attn_tc_products == before


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_card_route_groups_each_kv_head_as_one_batch_entry(shape, card_route):
    """One batch entry a (row, KV head), its query group's heads stacked
    as ``g·S`` rows; the products equal the einsum's to fp32 rounding and
    are counted; MLA's K and latent V go in as views, not copies."""
    q, k, v, p = _operands(shape, torch.bfloat16, seed=1)
    kvh, g = SHAPES[shape][:2]
    before = ox.attn_tc_products
    scores = ox._scores_payload(q, k)
    ctx = ox._ctx_payload(p, v)
    assert ox.attn_tc_products == before + 2
    (qa, kb), (pa, vb) = card_route
    assert qa.shape == (B * kvh, g * S, q.shape[-1])
    assert kb.shape == (B * kvh, q.shape[-1], S)
    assert pa.shape == (B * kvh, g * S, S)
    assert vb.shape == (B * kvh, S, v.shape[-1])
    assert all(x.dtype == torch.bfloat16 for x in (qa, kb, pa, vb))
    if SHAPES[shape][4]:
        assert kb.data_ptr() == k.data_ptr() and vb.data_ptr() == v.data_ptr()
        assert vb.stride(1) == k.shape[-1]
    torch.testing.assert_close(scores, _scores_einsum(q, k), rtol=1e-6,
                               atol=1e-5)
    torch.testing.assert_close(ctx, _ctx_einsum(p, v))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_ctx_rounds_p_to_v_dtype_exactly_once(shape, card_route):
    """The product reads p rounded to v's dtype, once, and the context is
    its fp32 sum rounded once to v's dtype."""
    _, _, v, p = _operands(shape, torch.bfloat16, seed=2)
    kvh = v.shape[1]
    ctx = ox._ctx_payload(p, v)
    (pa, vb), = card_route
    assert torch.equal(pa, p.to(torch.bfloat16).reshape(pa.shape))
    want = torch.bmm(pa.float(), vb.float()).reshape(ctx.shape)
    assert torch.equal(ctx, want.to(torch.bfloat16))
    # an fp32 V: p is not rounded at all
    v32 = v.float()
    ctx32 = ox._ctx_payload(p, v32)
    assert torch.equal(card_route[-1][0], p.reshape(B * kvh, -1, S))
    assert ctx32.dtype == torch.float32


@pytest.mark.parametrize("device", ["cuda", "cpu", "meta"])
@pytest.mark.parametrize("a,b", [(a, b) for a in sorted(DTYPES) + ["fp16"]
                                 for b in sorted(DTYPES) + ["fp16"]])
def test_route_is_bf16_pairs_on_cuda_only(device, a, b):
    dt = {**DTYPES, "fp16": torch.float16}
    assert ox.tc_route(device, dt[a], dt[b]) == (
        device == "cuda" and a == b == "bf16")
