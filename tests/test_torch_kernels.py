"""The port's fused GEMM kernels against the JAX package's.

On the CPU the port's wrappers run their plain versions; those are held
against the JAX references and against the Pallas kernels in interpret mode
(lattice shapes), and against the JAX references on off-lattice shapes and
zero-row groups.  Tolerances: fp32 1e-5 (same products, summation order
only); bf16 1e-2 (both accumulate in fp32 and round once to bf16, so they
differ by about one bf16 ulp at most).  The kernels themselves, on the
card, are held against these plain versions in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels.branch_gemm.kernel import branch_gemm_pallas  # noqa: E402
from repro.kernels.branch_gemm.ref import branch_gemm_ref as jax_branch_ref  # noqa: E402
from repro.kernels.grouped_gemm.kernel import grouped_gemm_pallas  # noqa: E402
from repro.kernels.grouped_gemm.ref import grouped_gemm_ref as jax_grouped_ref  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import TILE_M  # noqa: E402
from repro_torch.kernels.branch_gemm import ops as bops  # noqa: E402
from repro_torch.kernels.branch_gemm.ref import branch_gemm_ref  # noqa: E402
from repro_torch.kernels.grouped_gemm import ops as gops  # noqa: E402
from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref  # noqa: E402

DTYPES = {"float32": (np.float32, jnp.float32, 1e-5),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, 1e-2)}


def _arrays(shapes, np_dtype, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * (s[-2] ** -0.5 if i else 1.0)
             ).astype(np_dtype) for i, s in enumerate(shapes)]


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,m,k,f", [(2, 16, 128, 128), (3, 8, 256, 128)])
def test_branch_gemm_plain_matches_jax_ref_and_pallas(dtype, n, m, k, f):
    np_dt, jnp_dt, tol = DTYPES[dtype]
    x, w = _arrays([(n, m, k), (n, k, f)], np_dt, seed=n + m)
    got = bops.branch_gemm(bridge.array_to_tensor(x, "cpu"),
                           bridge.array_to_tensor(w, "cpu"))
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    _close(got, jax_branch_ref(jnp.asarray(x), jnp.asarray(w)), tol)
    pallas = branch_gemm_pallas(jnp.asarray(x, jnp_dt), jnp.asarray(w, jnp_dt),
                                bm=min(m, 128), bf=128, bk=128, interpret=True)
    _close(got, pallas, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,m,k,f", [(3, 77, 200, 136), (2, 1, 5, 3),
                                     (4, 9, 48, 80)])
def test_branch_gemm_plain_matches_jax_ref_off_lattice(dtype, n, m, k, f):
    np_dt, _, tol = DTYPES[dtype]
    x, w = _arrays([(n, m, k), (n, k, f)], np_dt, seed=k)
    got = branch_gemm_ref(bridge.array_to_tensor(x, "cpu"),
                          bridge.array_to_tensor(w, "cpu"))
    _close(got, jax_branch_ref(jnp.asarray(x), jnp.asarray(w)), tol)


def _padded(x_parts, bm):
    """The Pallas kernel's layout: each group zero-padded to ``bm`` rows."""
    segs, tile_group = [], []
    for i, x in enumerate(x_parts):
        m = x.shape[0]
        pad = -(-m // bm) * bm - m
        if m:
            segs.append(np.concatenate([x, np.zeros((pad, x.shape[1]),
                                                    x.dtype)]))
        tile_group += [i] * (-(-m // bm))
    return np.concatenate(segs), tuple(tile_group)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("sizes", [(8, 24, 16), (0, 16, 8), (32, 0, 0, 8)])
def test_grouped_gemm_plain_matches_jax_ref_and_pallas(dtype, sizes):
    np_dt, jnp_dt, tol = DTYPES[dtype]
    k, f = 128, 128
    x, w = _arrays([(sum(sizes), k), (len(sizes), k, f)], np_dt, seed=len(sizes))
    got = gops.grouped_gemm(bridge.array_to_tensor(x, "cpu"),
                            bridge.array_to_tensor(w, "cpu"), sizes)
    _close(got, jax_grouped_ref(jnp.asarray(x), jnp.asarray(w), sizes), tol)
    parts = np.split(x, np.cumsum(sizes)[:-1])
    bm = 8
    xp, tile_group = _padded(parts, bm)
    out = np.asarray(grouped_gemm_pallas(
        jnp.asarray(xp, jnp_dt), jnp.asarray(w, jnp_dt), tile_group, bm=bm,
        bf=128, bk=128, interpret=True), np.float32)
    unpadded, off = [], 0
    for m in sizes:
        unpadded.append(out[off:off + m])
        off += -(-m // bm) * bm
    _close(got, np.concatenate(unpadded), tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("sizes,k,f", [((3, 5, 9), 48, 80),
                                       ((0, 37, 70, 5), 200, 136),
                                       ((0, 0), 16, 16)])
def test_grouped_gemm_plain_matches_jax_ref_off_lattice(dtype, sizes, k, f):
    np_dt, _, tol = DTYPES[dtype]
    x, w = _arrays([(sum(sizes), k), (len(sizes), k, f)], np_dt, seed=k)
    got = grouped_gemm_ref(bridge.array_to_tensor(x, "cpu"),
                           bridge.array_to_tensor(w, "cpu"), sizes)
    assert tuple(got.shape) == (sum(sizes), f)
    _close(got, jax_grouped_ref(jnp.asarray(x), jnp.asarray(w), sizes), tol)


def test_grouped_gemm_parts_split_per_branch():
    x, w = _arrays([(20, 16), (3, 16, 8)], np.float32, seed=1)
    parts = [torch.from_numpy(p) for p in np.split(x, [4, 4])]
    outs = gops.grouped_gemm_parts(parts, torch.from_numpy(w))
    assert [tuple(o.shape) for o in outs] == [(4, 8), (0, 8), (16, 8)]
    want = grouped_gemm_ref(torch.from_numpy(x), torch.from_numpy(w),
                            (4, 0, 16))
    torch.testing.assert_close(torch.cat(outs), want, rtol=0, atol=0)


def test_tile_table_rows_skip_empty_groups_and_stop_at_group_end():
    rows = gops.tile_rows((0, TILE_M + 3, 0, 5))
    assert rows == [(1, 0, TILE_M + 3), (1, TILE_M, TILE_M + 3),
                    (3, TILE_M + 3, TILE_M + 8)]
    table = gops.tile_table((0, TILE_M + 3, 0, 5), "cpu")
    assert table.dtype == torch.int32 and tuple(table.shape) == (3, 3)
    assert tuple(gops.tile_table((0, 0), "cpu").shape) == (0, 3)


def test_cpu_wrappers_take_the_plain_version_and_count_no_launch():
    b0, g0 = bops.launches, gops.launches
    x = torch.randn(2, 3, 4)
    w = torch.randn(2, 4, 5)
    torch.testing.assert_close(bops.branch_gemm(x, w), branch_gemm_ref(x, w),
                               rtol=0, atol=0)
    gops.grouped_gemm(torch.randn(7, 4), w, (3, 4))
    assert (bops.launches, gops.launches) == (b0, g0)


@pytest.mark.parametrize("call,match", [
    (lambda: bops.branch_gemm(torch.zeros(2, 3, 4), torch.zeros(3, 4, 5)),
     "mismatch"),
    (lambda: bops.branch_gemm(torch.zeros(3, 4), torch.zeros(4, 5)), "N,M,K"),
    (lambda: gops.grouped_gemm(torch.zeros(12, 4), torch.zeros(2, 4, 5),
                               (10,)), "group sizes"),
    (lambda: gops.grouped_gemm(torch.zeros(12, 4), torch.zeros(2, 4, 5),
                               (4, 4)), "sum_M"),
    (lambda: gops.grouped_gemm(torch.zeros(12, 4), torch.zeros(2, 4, 5),
                               (14, -2)), "negative"),
])
def test_wrappers_validate_shapes(call, match):
    with pytest.raises(ValueError, match=match):
        call()


# ---- route and tile choice (host-side, no card needed) -----------------------

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.kernels.branch_gemm.kernel import WGMMA_TILES  # noqa: E402
from repro_torch.kernels.grouped_gemm.kernel import GROUPED_TILES  # noqa: E402


@settings(max_examples=300, deadline=None)
@given(n=st.integers(1, 64), m=st.integers(1, 70000), k=st.integers(1, 20000),
       f=st.integers(1, 70000))
def test_select_tiles_returns_a_compiled_instantiation(n, m, k, f):
    assert bops.select_tiles(n, m, k, f) in WGMMA_TILES
    bm, bn = bops.select_tiles(1, m, k, f, GROUPED_TILES)
    assert (bm, bn) in GROUPED_TILES and bm == TILE_M


@pytest.mark.parametrize("shape,tiles", [
    ((2, 512, 896, 4864), (128, 128)),    # Qwen2 gate||up: 3 full waves
    ((2, 512, 896, 128), (64, 64)),       # wk||wv: 32 blocks, not 8
    ((2, 512, 7168, 18432), (128, 256)),  # dense-prefix gate||up
    ((4, 512, 2048, 2048), (128, 256)),   # RWKV r||k||v||g: one wave
])
def test_select_tiles_at_the_main_path_shapes(shape, tiles):
    assert bops.select_tiles(*shape) == tiles


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _offset_view(*shape):
    """A contiguous bf16 tensor whose base lies 2 bytes past an aligned
    address (a view that starts one element into its storage)."""
    flat = _bf16(1 + int(np.prod(shape)))[1:]
    return flat.view(shape)


@pytest.mark.parametrize("x,w,want", [
    (_bf16(2, 512, 896), _bf16(2, 896, 4864), "wgmma"),   # gate||up
    (_bf16(2, 512, 896), _bf16(2, 896, 128), "wgmma"),    # wk||wv
    (_bf16(3, 77, 200), _bf16(3, 200, 136), "wgmma"),     # M, K off the tile
    (_bf16(1, 1, 8), _bf16(1, 8, 8), "wgmma"),
    (_bf16(1, 1, 1), _bf16(1, 1, 1), "simple"),           # K = 1
    (_bf16(2, 16, 12), _bf16(2, 12, 16), "simple"),       # K % 8 != 0
    (_bf16(2, 16, 16), _bf16(2, 16, 3), "simple"),        # F % 8 != 0
    (_bf16(2, 16, 0), _bf16(2, 0, 16), "simple"),         # K = 0
    (_offset_view(2, 16, 16), _bf16(2, 16, 16), "simple"),  # x base % 16
    (_bf16(2, 16, 16), _offset_view(2, 16, 16), "simple"),  # w base % 16
    (torch.zeros(2, 512, 896), torch.zeros(2, 896, 128), "fp32"),
    (torch.zeros(1, 1, 1), torch.zeros(1, 1, 1), "fp32"),
])
def test_route_rule_sends_only_tma_readable_bf16_to_wgmma(x, w, want):
    assert bops.route(x, w) == want


def test_grouped_route_takes_the_flat_operands():
    assert bops.route(_bf16(5120, 7168), _bf16(16, 7168, 4096)) == "wgmma"
    assert bops.route(_bf16(7, 5), _bf16(2, 5, 8)) == "simple"


def test_tile_rows_follow_tile_m_at_kimi_capacities():
    caps = (160, 181, 203, 224, 245, 267, 288, 309, 331, 352, 373, 395, 416,
            437, 459, 480)
    rows = gops.tile_rows(caps)
    assert len(rows) == sum(-(-c // TILE_M) for c in caps)
    # each tile covers up to TILE_M rows of its group; together every row once
    covered = [r for _, start, end in rows
               for r in range(start, min(start + TILE_M, end))]
    assert covered == list(range(sum(caps)))
    assert [r[0] for r in rows] == sorted(r[0] for r in rows)
