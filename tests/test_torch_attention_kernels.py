"""The port's rmsnorm and attention kernels' plain versions against the JAX
package's references and Pallas kernels.

On the CPU the port's wrappers run their plain versions (and count no
launch); those are held against the JAX ``ref.py`` and against the Pallas
kernels in interpret mode at lattice shapes small enough for the
interpret-mode grid limit, and against the JAX references off the lattice.
The JAX attention kernels take ``[B,H,S,D]`` / ``[P,KVH,ps,D]``; the port's
take the model / engine layout, so the tests transpose.

Tolerances: fp32 1e-5 (the same arithmetic in another summation order);
bf16 1e-2 for rmsnorm (one fp32-accumulated rounding on both sides: about
one bf16 ulp) and 2e-2 for attention (the decode plain versions round
probabilities to bf16 before the weighted sum, as the model's plain
attention does, and the JAX decode reference does not; the Pallas kernels
round them after an online softmax).  The kernels themselves are held
against these plain versions on the card in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import INTERPRET_GRID_LIMIT  # noqa: E402
from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.kernels.paged_decode.kernel import paged_decode_attention_pallas  # noqa: E402
from repro.kernels.paged_decode.ref import paged_decode_attention_ref as jax_paged_ref  # noqa: E402
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.paged_decode import ops as pops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rops  # noqa: E402

NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _arr(rng, shape, dtype, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(NP[dtype])


def _t(a):
    return bridge.array_to_tensor(a, "cpu")


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jnp.asarray(ref, jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(NP))
@pytest.mark.parametrize("n,d,lattice", [(16, 128, True), (8, 256, True),
                                         (3, 14, False), (5, 100, False)])
def test_rmsnorm_plain_matches_jax_ref_and_pallas(dtype, n, d, lattice):
    rng = np.random.default_rng(n * d)
    x, scale = _arr(rng, (n, d), dtype), _arr(rng, (d,), dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    before = rops.launches
    got = rops.rmsnorm(_t(x), _t(scale))
    assert rops.launches == before            # CPU tensors: no launch
    _close(got, jax_rmsnorm_ref(jnp.asarray(x), jnp.asarray(scale)), tol)
    if lattice:
        _close(got, rmsnorm_pallas(jnp.asarray(x), jnp.asarray(scale),
                                   bn=8, interpret=True), tol)


def _norm_operands(d, dtype=torch.bfloat16, offset=0):
    x = torch.zeros(1 + 4 * d, dtype=dtype)[offset:offset + 4 * d].view(4, d)
    return x, torch.zeros(d, dtype=dtype)


@pytest.mark.parametrize("d,dtype,offset,want", [
    (896, torch.bfloat16, 0, "onepass"),     # Qwen2-0.5B
    (2048, torch.bfloat16, 0, "onepass"),    # RWKV6-1.6B
    (7168, torch.bfloat16, 0, "onepass"),    # Kimi-K2, DeepSeek-V3
    (1536, torch.bfloat16, 0, "onepass"),    # DeepSeek-V3 q_norm
    (512, torch.bfloat16, 0, "onepass"),     # DeepSeek-V3 kv_norm
    (896, torch.float32, 0, "onepass"),
    (100, torch.float32, 0, "onepass"),      # 25 vectors
    (16384, torch.bfloat16, 0, "onepass"),   # the widest row it holds
    (16392, torch.bfloat16, 0, "simple"),    # one vector past it
    (14, torch.bfloat16, 0, "simple"),       # not a whole vector
    (100, torch.bfloat16, 0, "simple"),
    (896, torch.bfloat16, 1, "simple"),      # x base 2 bytes off
])
def test_rmsnorm_route_rule(d, dtype, offset, want):
    assert rops.route(*_norm_operands(d, dtype, offset)) == want


@pytest.mark.parametrize("d,want", [(896, (32, 4)), (2048, (64, 4)),
                                    (7168, (256, 4)), (1536, (64, 3)),
                                    (512, (32, 2)), (8, (32, 1)),
                                    (16384, (512, 4))])
def test_rmsnorm_layout_is_the_narrowest_team_that_holds_the_row(d, want):
    """The onepass layout at the widths the registered models normalise
    (bf16): the team's registers hold the row at <= 4 vectors a thread, and
    a team of half the threads would not."""
    from repro_torch.kernels.rmsnorm.kernel import select_layout
    nvec = d * 2 // 16
    tpr, vpt = select_layout(nvec)
    assert (tpr, vpt) == want
    assert tpr * vpt >= nvec and vpt <= 4
    assert tpr == 32 or (tpr // 2) * 4 < nvec


def test_rmsnorm_forced_simple_route_needs_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        rops.rmsnorm_simple(torch.zeros(2, 8), torch.ones(8))


@pytest.mark.parametrize("dtype", sorted(NP))
@pytest.mark.parametrize("b,s,h,kvh,d,window,lattice", [
    (1, 128, 2, 1, 16, 0, True), (1, 128, 2, 2, 16, 32, True),
    (2, 77, 4, 2, 14, 0, False), (1, 50, 2, 1, 8, 7, False)])
def test_flash_plain_matches_jax_ref_and_pallas(dtype, b, s, h, kvh, d,
                                                window, lattice):
    rng = np.random.default_rng(s + d)
    q = _arr(rng, (b, s, h, d), dtype)
    k, v = _arr(rng, (b, s, kvh, d), dtype), _arr(rng, (b, s, kvh, d), dtype)
    tol = ATTN_TOL[dtype]
    got = fops.flash_attention(_t(q), _t(k), _t(v), True, window)

    def heads_first(a):
        return jnp.swapaxes(jnp.asarray(a), 1, 2)

    qt, kt, vt = heads_first(q), heads_first(k), heads_first(v)
    want = jnp.swapaxes(jax_flash_ref(qt, kt, vt, True, window), 1, 2)
    _close(got, want, tol)
    if lattice:
        assert b * h * (s // 128) ** 2 <= INTERPRET_GRID_LIMIT
        pallas = flash_attention_pallas(qt, kt, vt, causal=True,
                                        window=window, bq=128, bk=128,
                                        interpret=True)
        _close(got, jnp.swapaxes(pallas, 1, 2), tol)


def _decode_case(dtype, b, h, kvh, t, d, seed):
    rng = np.random.default_rng(seed)
    q = _arr(rng, (b, h, d), dtype)
    k, v = _arr(rng, (b, t, kvh, d), dtype), _arr(rng, (b, t, kvh, d), dtype)
    pos = rng.integers(0, t, b)
    k_pos = np.arange(t)[None]
    valid = k_pos <= pos[:, None]
    valid[0] &= k_pos[0] > pos[0] - 20            # one windowed, ragged row
    return q, k, v, valid


@pytest.mark.parametrize("dtype", sorted(NP))
@pytest.mark.parametrize("b,h,kvh,t,d,lattice", [
    (2, 4, 2, 256, 16, True), (3, 7, 1, 200, 14, False)])
def test_decode_plain_matches_jax_ref_and_pallas(dtype, b, h, kvh, t, d,
                                                 lattice):
    q, k, v, valid = _decode_case(dtype, b, h, kvh, t, d, seed=t + d)
    tol = ATTN_TOL[dtype]
    before = dops.launches
    got = dops.decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(valid))
    assert dops.launches == before
    kt = jnp.swapaxes(jnp.asarray(k), 1, 2)
    vt = jnp.swapaxes(jnp.asarray(v), 1, 2)
    _close(got, jax_decode_ref(jnp.asarray(q), kt, vt, jnp.asarray(valid)),
           tol)
    if lattice:
        assert b * h * (t // 128) <= INTERPRET_GRID_LIMIT
        _close(got, decode_attention_pallas(jnp.asarray(q), kt, vt,
                                            jnp.asarray(valid), bk=128,
                                            interpret=True), tol)


def _paged_case(dtype, ps, d, seed):
    """Two sequences over shuffled pages: row 0 windowed so that its first
    page is fully masked, row 1 short with its trailing table entries on
    the null page 0."""
    rng = np.random.default_rng(seed)
    b, h, kvh, maxp = 2, 2, 1, 3
    n_pages = 1 + b * maxp
    q = _arr(rng, (b, h, d), dtype)
    kp = _arr(rng, (n_pages, ps, kvh, d), dtype)
    vp = _arr(rng, (n_pages, ps, kvh, d), dtype)
    bt = (rng.permutation(n_pages - 1) + 1).reshape(b, maxp).astype(np.int32)
    bt[1, 1:] = 0
    lengths = np.array([3 * ps - 5, ps // 2 + 1], np.int32)
    starts = np.array([ps + 3, 0], np.int32)
    return q, kp, vp, bt, lengths, starts


@pytest.mark.parametrize("dtype", sorted(NP))
@pytest.mark.parametrize("ps,d,lattice", [(128, 16, True), (16, 14, False),
                                          (5, 8, False)])
def test_paged_plain_matches_jax_ref_and_pallas(dtype, ps, d, lattice):
    q, kp, vp, bt, lengths, starts = _paged_case(dtype, ps, d, seed=ps + d)
    tol = ATTN_TOL[dtype]
    before = pops.launches
    got = pops.paged_decode_attention(_t(q), _t(kp), _t(vp),
                                      torch.from_numpy(bt),
                                      torch.from_numpy(lengths),
                                      torch.from_numpy(starts))
    assert pops.launches == before
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, lengths, starts)]
    _close(got, jax_paged_ref(*args), tol)
    if lattice:
        b, h = q.shape[:2]
        assert b * h * bt.shape[1] <= INTERPRET_GRID_LIMIT
        pallas = paged_decode_attention_pallas(
            args[0], jnp.swapaxes(args[1], 1, 2), jnp.swapaxes(args[2], 1, 2),
            args[3].reshape(-1), args[5], args[4], scale=d ** -0.5,
            interpret=True)
        _close(got, pallas, tol)


@pytest.mark.parametrize("dtype", sorted(NP))
def test_paged_plain_equals_dense_plain(dtype):
    """The two decode plain versions share one routine: a paged decode over
    gathered pages equals the dense decode of the same slab exactly."""
    q, kp, vp, bt, lengths, starts = _paged_case(dtype, 16, 16, seed=3)
    tq, tk, tv = _t(q), _t(kp), _t(vp)
    tbt = torch.from_numpy(bt)
    got = pops.paged_decode_attention(tq, tk, tv, tbt,
                                      torch.from_numpy(lengths),
                                      torch.from_numpy(starts))
    b, maxp = bt.shape
    slab_k = tk[tbt.long()].reshape(b, maxp * 16, *tk.shape[2:])
    slab_v = tv[tbt.long()].reshape(b, maxp * 16, *tv.shape[2:])
    posn = np.arange(maxp * 16)[None]
    valid = (posn < lengths[:, None]) & (posn >= starts[:, None])
    assert torch.equal(got, dops.decode_attention(
        tq, slab_k, slab_v, torch.from_numpy(valid)))


def test_wrappers_check_shapes_before_routing():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="scale"):
        rops.rmsnorm(x, torch.ones(7))
    with pytest.raises(ValueError, match="flash_attention"):
        fops.flash_attention(torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 2, 8),
                             torch.zeros(1, 4, 2, 8))
    with pytest.raises(ValueError, match="valid"):
        dops.decode_attention(torch.zeros(2, 4, 8), torch.zeros(2, 6, 2, 8),
                              torch.zeros(2, 6, 2, 8),
                              torch.ones(2, 5, dtype=torch.bool))
    with pytest.raises(ValueError, match="paged_decode"):
        pops.paged_decode_attention(torch.zeros(2, 4, 8),
                                    torch.zeros(3, 4, 2, 8),
                                    torch.zeros(3, 4, 2, 8),
                                    torch.zeros(3, 2, dtype=torch.int32),
                                    torch.ones(2, dtype=torch.int32))


# ---- flash_attention's route rule (what the wrapper picks on the card) ------

def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _fused_qkv_views():
    """q, k, v as views into one fused projection [B, S, H + 2 KVH, D]."""
    qkv = _bf16(2, 70, 8, 64)
    return qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]


@pytest.mark.parametrize("d,want", [(64, "wgmma"), (112, "wgmma"),
                                    (128, "wgmma"), (14, "simple"),
                                    (8, "simple")])
def test_flash_route_by_head_dim(d, want):
    q, kv = _bf16(1, 8, 4, d), _bf16(1, 8, 2, d)
    assert fops.route(q, kv, kv) == want


@pytest.mark.parametrize("case,want", [
    ("fp32", "fp32"),
    ("misaligned base", "simple"),
    ("D stride 2", "simple"),
    ("head stride 136 bytes", "simple"),
    ("fused projection views", "wgmma")])
def test_flash_route_by_dtype_alignment_and_strides(case, want):
    kv = _bf16(1, 8, 2, 64)
    if case == "fp32":
        q = kv = torch.zeros(1, 8, 2, 64)
    elif case == "misaligned base":
        q = _bf16(1 + 8 * 4 * 64)[1:].view(1, 8, 4, 64)
        assert q.data_ptr() % 16 != 0
    elif case == "D stride 2":
        q = _bf16(1, 8, 4, 128)[..., ::2]
    elif case == "head stride 136 bytes":
        q = _bf16(1, 8, 4, 68)[..., :64]
    if case == "fused projection views":
        q, k, v = _fused_qkv_views()
    else:
        k = v = kv
    assert fops.route(q, k, v) == want


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 14),
                                     (torch.float32, 64)])
def test_flash_cpu_wrapper_takes_the_plain_version_and_counts_nothing(dtype,
                                                                      d):
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.standard_normal((1, 20, 4, d))).to(dtype)
    k = torch.from_numpy(rng.standard_normal((1, 20, 2, d))).to(dtype)
    v = torch.from_numpy(rng.standard_normal((1, 20, 2, d))).to(dtype)
    before, by_route = fops.launches, dict(fops.launches_by_route)
    got = fops.flash_attention(q, k, v, True, 5)
    assert fops.launches == before and fops.launches_by_route == by_route
    assert torch.equal(got, flash_attention_ref(q, k, v, True, 5))
    with pytest.raises(ValueError, match="CUDA"):
        fops.flash_attention_simple_bf16(q, k, v)


# ---- the decode pair's route rule and split (what the wrappers pick on the
# card): pure functions of dtype, shapes, strides, alignment and SM count ---

def _slab_and_pages(d, dtype=torch.bfloat16, dv=None):
    """q [B,H,D], a slab [B,T,KVH,D] and pages [P,ps,KVH,D] of one dtype."""
    dv = d if dv is None else dv
    q = torch.zeros(2, 8, d, dtype=dtype)
    slab_k, slab_v = (torch.zeros(2, 40, 2, w, dtype=dtype) for w in (d, dv))
    page_k, page_v = (torch.zeros(7, 16, 2, w, dtype=dtype) for w in (d, dv))
    return q, (slab_k, slab_v), (page_k, page_v)


@pytest.mark.parametrize("d,dv,want", [(64, 64, "mma"), (112, 112, "mma"),
                                       (128, 128, "mma"), (40, 40, "mma"),
                                       (8, 8, "mma"), (64, 32, "mma"),
                                       (14, 14, "simple"), (64, 12, "simple"),
                                       (20, 20, "simple")])
def test_decode_route_by_head_dims_is_the_same_for_slab_and_pages(d, dv,
                                                                  want):
    q, slab, pages = _slab_and_pages(d, dv=dv)
    assert dops.route(q, *slab) == want
    assert dops.route(q, *pages) == want
    q32, slab32, pages32 = _slab_and_pages(d, torch.float32, dv)
    assert dops.route(q32, *slab32) == dops.route(q32, *pages32) == "fp32"


@pytest.mark.parametrize("case,want", [
    ("contiguous", "mma"),
    ("misaligned q base", "simple"),
    ("misaligned cache base", "simple"),
    ("D stride 2", "simple"),
    ("head stride 144 bytes", "mma"),
    ("head stride 136 bytes", "simple"),
    ("fused projection views", "mma")])
def test_decode_route_by_alignment_and_strides(case, want):
    q, (k, v), (kp, vp) = _slab_and_pages(64)
    if case == "misaligned q base":
        q = _bf16(1 + 2 * 8 * 64)[1:].view(2, 8, 64)
        assert q.data_ptr() % 16 != 0
    elif case == "misaligned cache base":
        k = _bf16(4 + 2 * 40 * 2 * 64)[4:].view(2, 40, 2, 64)
        kp = _bf16(4 + 7 * 16 * 2 * 64)[4:].view(7, 16, 2, 64)
        assert k.data_ptr() % 16 != 0
    elif case == "D stride 2":
        k = _bf16(2, 40, 2, 128)[..., ::2]
        kp = _bf16(7, 16, 2, 128)[..., ::2]
    elif case == "head stride 144 bytes":
        k = _bf16(2, 40, 2, 72)[..., :64]
        kp = _bf16(7, 16, 2, 72)[..., :64]
    elif case == "head stride 136 bytes":
        k = _bf16(2, 40, 2, 68)[..., :64]
        kp = _bf16(7, 16, 2, 68)[..., :64]
    elif case == "fused projection views":
        qkv = _bf16(2, 1, 12, 64)
        q = qkv[:, 0, :8]
    assert dops.route(q, k, v) == want
    assert dops.route(q, kp, vp) == want


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("b,kvh,t", [(8, 2, 1024), (8, 8, 1024), (1, 1, 1024),
                                     (3, 2, 200), (2, 1, 5), (64, 8, 4096),
                                     (1, 2, 32768), (16, 2, 17)])
def test_decode_split_is_whole_tiles_filling_the_card(sms, b, kvh, t):
    from repro_torch.kernels import DECODE_MAX_SPLITS, DECODE_TILE
    from repro_torch.kernels.decode_attention.kernel import split_len
    split = split_len(b, kvh, t, sms)
    n = -(-t // split)
    tiles = -(-t // DECODE_TILE)
    assert split % DECODE_TILE == 0 and split > 0
    assert n <= DECODE_MAX_SPLITS
    # about one block an SM: no more blocks than SMs unless the pairs alone
    # outnumber them, and fewer only by less than a split a pair, or where
    # the tiles or the cluster run out
    pairs = b * kvh
    assert pairs * n <= max(sms, pairs)
    assert pairs * n > min(sms - pairs, pairs * min(tiles, DECODE_MAX_SPLITS)
                           - 1)
    # no split is empty, and a split never depends on the layout: a table of
    # MAXP pages of ps positions with MAXP * ps == T splits the same
    assert (n - 1) * split < t
    for ps in (1, 5, 16):
        if t % ps == 0:
            assert split_len(b, kvh, (t // ps) * ps, sms) == split


def test_decode_split_at_the_serving_shapes():
    """Qwen2-0.5B (8 slots x 2 KV heads) and Kimi-K2 (8 x 8) at 1024
    positions on an H100's 132 SMs: 8 splits of 128 positions (128 blocks)
    and 2 of 512 (128 blocks)."""
    from repro_torch.kernels.decode_attention.kernel import split_len
    assert split_len(8, 2, 1024, 132) == 128
    assert split_len(8, 8, 1024, 132) == 512


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 14),
                                     (torch.float32, 64)])
def test_decode_cpu_wrappers_take_the_plain_version_and_count_nothing(dtype,
                                                                      d):
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.paged_decode.ref import paged_decode_attention_ref
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.standard_normal((2, 4, d))).to(dtype)
    k = torch.from_numpy(rng.standard_normal((2, 32, 2, d))).to(dtype)
    v = torch.from_numpy(rng.standard_normal((2, 32, 2, d))).to(dtype)
    valid = torch.arange(32)[None] < torch.tensor([[20], [32]])
    pages_k, pages_v = k.reshape(4, 16, 2, d), v.reshape(4, 16, 2, d)
    bt = torch.arange(4, dtype=torch.int32).reshape(2, 2)
    lengths = torch.tensor([20, 32], dtype=torch.int32)
    before = (dops.launches, dict(dops.launches_by_route), pops.launches,
              dict(pops.launches_by_route))
    got = dops.decode_attention(q, k, v, valid)
    got_p = pops.paged_decode_attention(q, pages_k, pages_v, bt, lengths)
    assert (dops.launches, dops.launches_by_route, pops.launches,
            pops.launches_by_route) == before
    assert torch.equal(got, decode_attention_ref(q, k, v, valid))
    assert torch.equal(got_p, paged_decode_attention_ref(
        q, pages_k, pages_v, bt, lengths))
    assert torch.equal(got_p, got)
    with pytest.raises(ValueError, match="CUDA"):
        dops.decode_attention_simple_bf16(q, k, v, valid)
    with pytest.raises(ValueError, match="CUDA"):
        pops.paged_decode_simple_bf16(q, pages_k, pages_v, bt, lengths)
