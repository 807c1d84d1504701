"""``utils/sharding_ctx.on_local_shards``: how an op written in einsum
notation is laid out over a 2×2 mesh before each rank runs it on its local
shards, checked on meta ``DTensor``s in a fake world of 4 ranks (one
process, no data moved).  The numbers of the sharded products, combines and
scans are held against one process on 4 gloo ranks in
``test_torch_distributed.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro_torch.launch.mesh import fake_world, make_debug_mesh  # noqa: E402
from repro_torch.models.layers import linear, matmul_f32  # noqa: E402
from repro_torch.parallel.sharding import place  # noqa: E402
from repro_torch.utils.sharding_ctx import on_local_shards  # noqa: E402


@pytest.fixture(scope="module")
def mesh():
    with fake_world(4):
        yield make_debug_mesh(2, 2, device_type="cpu")


def _meta(mesh, shape, spec, dtype=torch.float32, grad=False):
    x = place(torch.empty(shape, device="meta", dtype=dtype), mesh, spec)
    return x.requires_grad_() if grad else x


class _Seen:
    """``fn`` / ``fn_partial`` stand-ins that record the local operands and
    return ``out(*locals)``."""

    def __init__(self, out):
        self.out, self.calls = out, []

    def fn(self, *t):
        self.calls.append(("fn", [None if u is None else
                                  (tuple(u.shape), u.dtype) for u in t]))
        return self.out(*t)

    def partial(self, *t):
        self.calls.append(("partial", [None if u is None else
                                       (tuple(u.shape), u.dtype) for u in t]))
        return self.out(*t).float()


def _mm(a, b):
    return torch.matmul(a.float(), b.float()).to(a.dtype)


# (name, x shape, x spec, w shape, w spec, which fn, x local, w local,
#  output placements on (data, model))
PRODUCTS = [
    ("column-parallel", (8, 16, 32), ("data", None, None), (32, 64),
     ("data", "model"), "fn", (4, 16, 32), (32, 32), [Shard(0), Shard(2)]),
    ("row-parallel", (8, 16, 64), ("data", None, "model"), (64, 32),
     ("model", "data"), "partial", (4, 16, 32), (32, 32),
     [Shard(0), Replicate()]),
    ("sequence split kept, weight gathered", (2, 16, 32),
     (None, "data", None), (32, 64), ("data", "model"), "fn", (2, 8, 32),
     (32, 32), [Shard(1), Shard(2)]),
    ("output split preferred over a contracted one", (8, 16, 64),
     (None, None, "model"), (64, 32), (None, "model"), "fn", (8, 16, 64),
     (64, 16), [Replicate(), Shard(2)]),
    ("replicated", (8, 16, 32), (None, None, None), (32, 64), (None, None),
     "fn", (8, 16, 32), (32, 64), [Replicate(), Replicate()]),
]


@pytest.mark.parametrize("case", PRODUCTS, ids=[c[0] for c in PRODUCTS])
def test_product_layout(mesh, case):
    """Each mesh dim keeps the split an operand has there and the output
    keeps (the activation's first), else a contracted one (a row-parallel
    product, whose partial sums take ``fn_partial`` and are reduced)."""
    _, xs, xspec, ws, wspec, which, xl, wl, out_pl = case
    seen = _Seen(_mm)
    y = on_local_shards(seen.fn, "abk,kn->abn", _meta(mesh, xs, xspec),
                        _meta(mesh, ws, wspec), fn_partial=seen.partial,
                        dtype=torch.float32)
    assert [c[0] for c in seen.calls] == [which]
    assert [s for s, _ in seen.calls[0][1]] == [xl, wl]
    assert isinstance(y, DTensor) and list(y.placements) == out_pl
    assert tuple(y.shape) == xs[:-1] + ws[-1:]


def test_expert_product_splits_the_contraction(mesh):
    """``matmul_f32`` over an expert stack split [model, data, -]: the
    experts stay split and the contraction is split over "data", its
    partial sums reduced in fp32 to an fp32 result."""
    buf = _meta(mesh, (4, 6, 32), ("model", None, None), torch.bfloat16)
    gate = _meta(mesh, (4, 32, 16), ("model", "data", None), torch.bfloat16)
    out = matmul_f32(buf, gate)
    assert out.dtype == torch.float32 and tuple(out.shape) == (4, 6, 16)
    assert list(out.placements) == [Replicate(), Shard(0)]
    assert out.to_local().shape == (2, 6, 16)


def test_column_parallel_input_grad_is_summed_in_fp32(mesh):
    """A bf16 activation whose grad is a sum over the "model" split (the
    backward of a column-parallel product) reaches the product in fp32; the
    weight, whose grad sums over "data", stays bf16."""
    seen = _Seen(_mm)
    x = _meta(mesh, (8, 16, 32), ("data", None, None), torch.bfloat16,
              grad=True)
    w = _meta(mesh, (32, 64), ("data", "model"), torch.bfloat16, grad=True)
    y = on_local_shards(seen.fn, "abk,kn->abn", x, w,
                        fn_partial=seen.partial, f32_grads=(0,),
                        dtype=torch.bfloat16)
    assert [d for _, d in seen.calls[0][1]] == [torch.float32,
                                                torch.bfloat16]
    assert y.dtype == torch.bfloat16


def test_linear_keeps_plain_tensors_plain():
    """Outside a mesh nothing of it runs: ``linear`` is ``x @ w``, bit for
    bit."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 8, generator=g).to(torch.bfloat16)
    w = torch.randn(8, 6, generator=g).to(torch.bfloat16)
    assert torch.equal(linear({"w": w}, x), torch.matmul(x, w))


# attention: q [B,S,H,D], k and v [B,T,KVH,D], the batch split
@pytest.mark.parametrize("kvh, q_split, q_local, k_local", [
    (4, "heads", (4, 16, 4, 8), (4, 16, 2, 8)),   # K/V heads split as q's
    (1, "heads", (4, 16, 4, 8), (4, 16, 1, 8)),   # one latent head, whole
    (3, "heads", (4, 16, 8, 8), (4, 16, 3, 8)),   # 3 KV heads: none split
    (4, "seq", (4, 16, 8, 8), (4, 16, 4, 8)),     # the sequence made whole
])
def test_attention_layout(mesh, kvh, q_split, q_local, k_local):
    from repro_torch.models.attention import _attend_on_shards
    seen = _Seen(lambda q, k, v, m: torch.empty_like(q))
    spec = {"heads": ("data", None, "model", None),
            "seq": ("data", "model", None, None)}[q_split]
    q = _meta(mesh, (8, 16, 8, 8), spec)
    k = _meta(mesh, (8, 16, kvh, 8), ("data", None, None, None))
    out = _attend_on_shards(seen.fn, q, k, k)
    assert [s for s, _ in seen.calls[0][1][:2]] == [q_local, k_local]
    assert tuple(out.shape) == (8, 16, 8, 8)


def test_decode_over_a_split_cache_is_not_made_whole(mesh):
    """A query against a cache split along its positions (long-context
    decode) is left to ``DTensor``'s own propagation, which reduces the
    softmax across ranks, where the per-shard rule would gather the
    cache."""
    from repro_torch.models.attention import _per_shard
    q = _meta(mesh, (2, 1, 8, 8), (None, None, "model", None))
    cache = _meta(mesh, (2, 64, 4, 8), (None, "data", None, None))
    prefill = _meta(mesh, (2, 64, 8, 8), (None, "data", None, None))
    assert not _per_shard(q, cache)
    assert _per_shard(prefill, cache)


def test_scan_makes_a_split_sequence_whole(mesh):
    """A recurrence keeps its independent letters split and gathers the
    sequence, along which its state runs."""
    seen = _Seen(lambda r, s: (torch.empty_like(s), torch.empty_like(r)))
    r = _meta(mesh, (8, 16, 4, 6), ("data", "model", None, None))
    s0 = _meta(mesh, (8, 4, 6, 6), ("data", None, None, None))
    s, y = on_local_shards(seen.fn, "bthk,bhkj->bhkj,bthk", r, s0,
                           split="bh")
    assert [sh for sh, _ in seen.calls[0][1]] == [(4, 16, 4, 6),
                                                  (4, 4, 6, 6)]
    assert list(y.placements) == [Shard(0), Replicate()]
    assert tuple(s.shape) == (8, 4, 6, 6)


def test_a_split_contraction_without_fn_partial_raises(mesh):
    """No fallback: an op that cannot run per shard raises."""
    x = _meta(mesh, (8, 16, 64), ("data", None, "model"))
    w = _meta(mesh, (64, 32), ("model", "data"))
    with pytest.raises(ValueError, match="contracted"):
        on_local_shards(_mm, "abk,kn->abn", x, w)
