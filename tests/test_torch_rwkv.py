"""The port's RWKV-6 family against the JAX package's.

Held on numpy-seeded inputs and on params drawn by the JAX ``init`` and
converted bit-exactly by ``repro_torch.bridge``:

* the ``rwkv6`` kernel's plain version against ``rwkv6_ref`` and the Pallas
  kernel in interpret mode, and at odd T against the reference;
* the chunked route's algebra (``rwkv6_chunked_ref``) against both and the
  port's sequential loop, with strong decays (exact zeros, 1 - 1e-7) and
  decays near 1, T below, at and past a chunk, and a hypothesis sweep over
  (T, chunk); the wrappers' route rule, strided model-layout views, and
  that the CPU takes the plain version and counts nothing;
* the time mix (both routes) against ``repro.models.ssm``;
* the RWKV6 smoke ``Model``: prefill and 3 decode steps, on the plain route
  and on the kernel route (whose decode steps run the recurrence at T = 1);
* the op graph with its ``.wkv_scan`` nodes through the port's ``Session``
  against the JAX package's captured program;
* the serving engine on the overload trace, and ``paged_kv=True`` degrading
  to the dense slab with the JAX package's warning.

Tolerances: fp32 1e-5 (1e-4 for the recurrence over 64 steps, as the JAX
package's own kernel test: the state sums many terms in another order; the
chunked algebra against the port's loop 1e-5 of max|loop|, the bound its
kernel is held to on the card);
bf16 2e-2 relative L2 over the tensor, the JAX package's bf16 differential
tolerance.
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from benchmarks.bench_serving import _drive as ref_drive  # noqa: E402
from benchmarks.bench_serving import build_trace  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.scheduler import compile_plan as ref_compile  # noqa: E402
from repro.core.scheduler import schedule as ref_schedule  # noqa: E402
from repro.kernels.rwkv6.kernel import rwkv6_pallas  # noqa: E402
from repro.kernels.rwkv6.ref import rwkv6_ref as jax_rwkv6_ref  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.opgraph_export import build_lm_opgraph as ref_export  # noqa: E402
from repro.runtime import DegradationWarning as RefDegradationWarning  # noqa: E402
from repro.runtime.faults import FaultPlan as RefFaultPlan  # noqa: E402
from repro.serving import AdmissionConfig as RefAdmission  # noqa: E402
from repro.serving import InferenceEngine as RefEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import V5E, Session, SessionConfig  # noqa: E402
from repro_torch.core.capture import run_sequential_uncompiled  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as rops  # noqa: E402
from repro_torch.kernels.rwkv6.ref import rwkv6_chunked_ref  # noqa: E402
from repro_torch.kernels.rwkv6.ref import rwkv6_ref as port_wkv_ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.opgraph_export import build_lm_opgraph  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402
from repro_torch.runtime.faults import FaultPlan  # noqa: E402
from repro_torch.runtime.guard import DegradationWarning  # noqa: E402
from repro_torch.serving import (AdmissionConfig, InferenceEngine,  # noqa: E402
                                 Request)

ARCH = "rwkv6-1.6b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(port, ref, tol):
    got, want = _np(port), _np(ref)
    assert got.shape == want.shape
    if tol == DTYPES["bfloat16"][2]:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= tol, f"relative L2 {rel:.3g} > {tol}"
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _tree(params):
    return bridge.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")


def _wkv_inputs(b, h, t, k, seed):
    rng = np.random.default_rng(seed)
    r, kk, vv = [rng.standard_normal((b, h, t, k)).astype(np.float32)
                 for _ in range(3)]
    w = rng.uniform(0.8, 0.999, (b, h, t, k)).astype(np.float32)
    u = rng.standard_normal((h, k)).astype(np.float32)
    s0 = rng.standard_normal((b, h, k, k)).astype(np.float32)
    return r, kk, vv, w, u, s0


# -- the rwkv6 kernel's plain version --------------------------------------------

@pytest.mark.parametrize("t,ct", [(32, 8), (64, 16), (24, 8), (17, None),
                                  (1, None)])
def test_rwkv6_plain_matches_jax_ref_and_pallas(t, ct):
    arrs = _wkv_inputs(2, 2, t, 16, t)
    launches = rops.launches
    out, s_final = rops.rwkv6(*[torch.from_numpy(a) for a in arrs])
    assert rops.launches == launches          # the CPU runs the plain version
    jarrs = [jnp.asarray(a) for a in arrs]
    want_o, want_s = jax_rwkv6_ref(*jarrs)
    _close(out, want_o, 1e-4)
    _close(s_final, want_s, 1e-4)
    if ct is not None:
        po, ps = rwkv6_pallas(*jarrs, ct=ct, interpret=True)
        _close(out, po, 1e-4)
        _close(s_final, ps, 1e-4)


def test_rwkv6_model_layout_adapter_matches_the_scan():
    arrs = _wkv_inputs(2, 3, 9, 8, 4)
    r, k, v, w = [np.swapaxes(a, 1, 2) for a in arrs[:4]]
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in (r, k, v, w)]
    u, s0 = torch.from_numpy(arrs[4]), torch.from_numpy(arrs[5])
    y, s_final = rops.rwkv6_model(*tensors, u, s0)
    want_s, want_y = ref_ssm.wkv_scan_ref(*[jnp.asarray(a) for a in
                                            (r, k, v, w)],
                                          jnp.asarray(arrs[4]),
                                          jnp.asarray(arrs[5]))
    _close(y, want_y, 1e-4)
    _close(s_final, want_s, 1e-4)
    s_plain, y_plain = ssm.wkv_scan_ref(*tensors, u, s0)
    _close(y, y_plain, 1e-5)
    _close(s_final, s_plain, 1e-5)


def test_rwkv6_checks_shapes_before_routing():
    x = torch.zeros((1, 2, 3, 4))
    with pytest.raises(ValueError, match="one shape"):
        rops.rwkv6(x, x, x, x[:, :, :2], torch.zeros((2, 4)),
                   torch.zeros((1, 2, 4, 4)))
    with pytest.raises(ValueError, match="u \\[H,K\\]"):
        rops.rwkv6(x, x, x, x, torch.zeros((3, 4)),
                   torch.zeros((1, 2, 4, 4)))


# -- the chunked route's algebra (plain PyTorch), strong decays ------------------
# Held at 1e-5 of max|sequential| against the port's sequential loop (the
# kernel's own bound on the card: summation order only) and at the JAX
# package's 1e-4 against its reference and its Pallas kernel in interpret
# mode.

def _strong_decays(rng, shape):
    """w over (0, 1) with exact zeros and values 1 - 1e-7 mixed in (fp32's
    exp(-exp(w_log)) is exactly 0 once w_log > ~4.5, and trained RWKV-6
    checkpoints have such channels)."""
    w = rng.uniform(0.0, 1.0, shape)
    pick = rng.uniform(size=shape)
    w[pick < 0.15] = 0.0
    w[pick > 0.85] = 1.0 - 1e-7
    return w.astype(np.float32)


def _chunk_inputs(b, h, t, k, seed, decays="strong"):
    """``_wkv_inputs`` with strong decays or decays within 2e-3 of 1."""
    r, kk, vv, w, u, s0 = _wkv_inputs(b, h, t, k, seed)
    rng = np.random.default_rng(seed + 1)
    if decays == "strong":
        w = _strong_decays(rng, w.shape)
    else:
        w = (1.0 - rng.uniform(1e-7, 2e-3, w.shape)).astype(np.float32)
    return r, kk, vv, w, u, s0


def _rel_close(got, want, rel=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("decays", ["strong", "near one"])
@pytest.mark.parametrize("t,chunk,sub", [(1, 64, 16), (17, 64, 16),
                                         (64, 64, 16), (100, 64, 16),
                                         (33, 16, 8), (40, 8, 8)])
def test_rwkv6_chunked_ref_matches_jax_ref_pallas_and_the_loop(t, chunk, sub,
                                                               decays):
    arrs = _chunk_inputs(2, 2, t, 16, 100 + t, decays)
    tens = [torch.from_numpy(a) for a in arrs]
    out, s_final = rwkv6_chunked_ref(*tens, chunk=chunk, sub=sub)
    want_o, want_s = port_wkv_ref(*tens)
    _rel_close(out, want_o)
    _rel_close(s_final, want_s)
    jarrs = [jnp.asarray(a) for a in arrs]
    jo, js = jax_rwkv6_ref(*jarrs)
    _close(out, jo, 1e-4)
    _close(s_final, js, 1e-4)
    if t % 8 == 0:
        po, ps = rwkv6_pallas(*jarrs, ct=8, interpret=True)
        _close(out, po, 1e-4)
        _close(s_final, ps, 1e-4)


def test_rwkv6_chunked_ref_gives_exact_zeros_where_every_decay_is_zero():
    """w = 0 everywhere: the state forgets at every step, so each output is
    its own step's bonus term plus r_t . (k_{t-1}^T v_{t-1}), and the final
    state is k_T^T v_T; no NaN or inf from a product of zeros."""
    r, k, v, _, u, s0 = (torch.from_numpy(a) for a in
                         _wkv_inputs(1, 2, 70, 8, 7))
    w = torch.zeros_like(r)
    out, s_final = rwkv6_chunked_ref(r, k, v, w, u, s0)
    want_o, want_s = port_wkv_ref(r, k, v, w, u, s0)
    _rel_close(out, want_o)
    _rel_close(s_final, want_s)
    torch.testing.assert_close(
        s_final, k[:, :, -1, :, None] * v[:, :, -1, None, :], rtol=0, atol=0)


@settings(max_examples=25, deadline=None)
@given(t=st.integers(1, 90), sub=st.sampled_from([4, 8, 16]),
       subs=st.integers(1, 4), seed=st.integers(0, 2**16))
def test_rwkv6_chunked_ref_sweep_over_t_and_chunk(t, sub, subs, seed):
    arrs = _chunk_inputs(1, 2, t, 8, seed)
    tens = [torch.from_numpy(a) for a in arrs]
    out, s_final = rwkv6_chunked_ref(*tens, chunk=sub * subs, sub=sub)
    want_o, want_s = port_wkv_ref(*tens)
    _rel_close(out, want_o)
    _rel_close(s_final, want_s)


# -- the wrappers on the CPU: routes, layouts, counts -----------------------------

def test_rwkv6_model_on_strided_views_equals_the_contiguous_path():
    """The model layout handed over as strided views (a slice of a wider
    buffer, the r/k/v/w columns of one projection) gives what contiguous
    copies give, and y comes back contiguous [B,T,H,K]."""
    b, t, h, k = 2, 9, 3, 8
    rng = np.random.default_rng(11)
    wide = torch.from_numpy(rng.standard_normal((b, t, 4, h, k + 4))
                            .astype(np.float32))
    views = [wide[:, :, i, :, :k] for i in range(4)]
    views[3] = torch.sigmoid(views[3])
    assert not views[0].is_contiguous()
    u = torch.from_numpy(rng.standard_normal((h, k)).astype(np.float32))
    s0 = torch.from_numpy(rng.standard_normal((b, h, k, k)).astype(np.float32))
    y, s_final = rops.rwkv6_model(*views, u, s0)
    want_y, want_s = rops.rwkv6_model(*[x.contiguous() for x in views], u, s0)
    assert y.shape == (b, t, h, k) and y.is_contiguous()
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(s_final, want_s, rtol=0, atol=0)


def test_rwkv6_route_rule_by_t_dtype_and_strides():
    k = 64
    short = torch.zeros(1, 2, rops.CHUNKED_MIN_T - 1, k)
    long = torch.zeros(1, 2, rops.CHUNKED_MIN_T, k)
    assert rops.route(short, short, short, short) == "step"
    assert rops.route(long, long, long, long) == "chunked"
    # the model layout's transposed view: strides H*K, K, T*H*K
    model = torch.zeros(1, 512, 32, k).transpose(1, 2)
    assert rops.route(model, model, model, model) == "chunked"
    # a K off the 4-element vector, a base off 16 bytes, an odd stride
    odd_k = torch.zeros(1, 2, 64, 14)
    assert rops.route(odd_k, odd_k, odd_k, odd_k) == "step"
    full = torch.zeros(1, 2, 64, k)
    shifted = torch.zeros(2 * 64 * k + 4)[1:2 * 64 * k + 1].view(1, 2, 64, k)
    assert rops.route(full, full, full, full) == "chunked"
    assert rops.route(full, full, shifted, full) == "step"
    strided = torch.zeros(1, 2, 64, k + 2)[..., :k]
    assert rops.route(strided, strided, strided, strided) == "step"
    with pytest.raises(TypeError, match="fp32"):
        rops.route(long.bfloat16(), long, long, long)


def test_rwkv6_cpu_wrappers_take_the_plain_version_and_count_nothing():
    arrs = [torch.from_numpy(a) for a in _chunk_inputs(1, 2, 70, 16, 3)]
    before, by_route = rops.launches, dict(rops.launches_by_route)
    out, s_final = rops.rwkv6(*arrs)
    want_o, want_s = port_wkv_ref(*arrs)
    torch.testing.assert_close(out, want_o, rtol=0, atol=0)
    torch.testing.assert_close(s_final, want_s, rtol=0, atol=0)
    r, k, v, w = (x.transpose(1, 2) for x in arrs[:4])
    y, _ = rops.rwkv6_model(r, k, v, w, *arrs[4:])
    torch.testing.assert_close(y, want_o.transpose(1, 2), rtol=0, atol=0)
    assert rops.launches == before
    assert rops.launches_by_route == by_route


def test_rwkv6_step_refuses_cpu_tensors():
    arrs = [torch.from_numpy(a) for a in _chunk_inputs(1, 2, 5, 8, 1)]
    with pytest.raises(ValueError, match="CUDA"):
        rops.rwkv6_step(*arrs)


# -- the time mix and the model -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup(dtype: str):
    jdt, tdt, _ = DTYPES[dtype]
    rcfg = dataclasses.replace(ref_config(ARCH, smoke=True), dtype=jdt)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=tdt)
    rmodel = RefModel(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, rcfg.vocab_size, (2, 11)).astype(np.int32)
    steps = rng.integers(1, rcfg.vocab_size, (3, 2)).astype(np.int32)
    return rcfg, cfg, rmodel, rparams, _tree(rparams), tokens, steps


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_time_mix_matches_reference(dtype, use_kernels):
    jdt, tdt, tol = DTYPES[dtype]
    rcfg, cfg, _, rparams, params, _, _ = _setup(dtype)
    rp = jax.tree_util.tree_map(lambda a: a[0],
                                rparams["stacks"][0]["time_mix"])
    p = layer_params(params["stacks"][0]["time_mix"], 0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    x_prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    s0 = rng.standard_normal((2, 4, 16, 16)).astype(np.float32) * 0.1
    ry, (rx, rs) = ref_ssm.rwkv_time_mix_seq(
        rp, jnp.asarray(x, jdt), (jnp.asarray(x_prev, jdt), jnp.asarray(s0)),
        rcfg)
    y, (tx, ts) = ssm.rwkv_time_mix_seq(
        p, torch.from_numpy(x).to(tdt),
        (torch.from_numpy(x_prev).to(tdt), torch.from_numpy(s0)), cfg,
        use_kernels)
    _close(y, ry, tol)
    _close(tx, rx, tol)
    _close(ts, rs, max(tol, 1e-4))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv_prefill_and_decode_match_reference(dtype, use_kernels):
    _, _, tol = DTYPES[dtype]
    rcfg, cfg, rmodel, rparams, params, tokens, steps = _setup(dtype)
    model = Model(cfg, use_kernels=use_kernels)
    r_logits, r_caches = rmodel.prefill(rparams,
                                        {"tokens": jnp.asarray(tokens)},
                                        cache_len=24)
    logits, caches = model.prefill(
        params, {"tokens": torch.from_numpy(tokens).long()}, cache_len=24)
    _close(logits, r_logits, tol)
    assert sorted(caches[0]) == sorted(r_caches[0]) == ["cm_x", "tm_s",
                                                        "tm_x"]
    for key in caches[0]:
        # recurrent state keeps no sequence axis: nothing is padded
        assert tuple(caches[0][key].shape) == r_caches[0][key].shape
        _close(caches[0][key], r_caches[0][key], max(tol, 1e-4))
    before = {k: v.data_ptr() for k, v in caches[0].items()}
    for i, tok in enumerate(steps):
        pos = np.full((2,), 11 + i, np.int32)
        r_logits, r_caches = rmodel.decode(rparams, jnp.asarray(tok),
                                           r_caches, jnp.asarray(pos))
        logits, caches = model.decode(params, torch.from_numpy(tok).long(),
                                      caches, torch.from_numpy(pos))
        _close(logits, r_logits, tol)
    assert {k: v.data_ptr() for k, v in caches[0].items()} == before
    for key in caches[0]:
        _close(caches[0][key], r_caches[0][key], max(tol, 1e-4))


def test_paged_caches_refuse_recurrent_state():
    _, cfg, *_ = _setup("float32")
    assert not Model(cfg).supports_paged()
    with pytest.raises(ValueError, match="recurrent state"):
        Model(cfg).init_paged_caches(8, 4, "cpu")


# -- the op graph --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv_op_graph_matches_reference(dtype, tmp_path):
    _, _, tol = DTYPES[dtype]
    rcfg, cfg, _, rparams, params, _, _ = _setup(dtype)
    rg = ref_export(rcfg, batch=2, seq=8, params=rparams)
    pg = build_lm_opgraph(cfg, batch=2, seq=8, params=params)
    assert pg.node_signature() == rg.node_signature()
    assert sum(n.name.endswith(".wkv_scan") for n in pg) == cfg.n_layers
    rexe = ref_compile(ref_schedule(rg, "opara", "opara"),
                       gemm_kernel="pallas")
    sess = Session(SessionConfig(device="cpu", hw=V5E,
                                 calib_dir=str(tmp_path)))
    tok = np.random.default_rng(5).integers(0, rcfg.vocab_size,
                                            (2, 8)).astype(np.int32)
    model = sess.compile(pg, inputs={0: torch.from_numpy(tok).long()})
    assert model.executable.program_stats()["n_branch_gemm"] >= 1
    launches = rops.launches
    got = model({"tokens": torch.from_numpy(tok)})
    assert rops.launches == launches          # the CPU runs the plain version
    want = rexe({"tokens": jnp.asarray(tok)})
    _close(got[-1], want[-1], tol)
    seq = run_sequential_uncompiled(pg, {"tokens": torch.from_numpy(tok)},
                                    model.executable.output_ids)
    _close(got[-1], seq[-1], tol)


# -- serving --------------------------------------------------------------------------

def _drive(engine, trace, max_ticks: int = 400):
    """``benchmarks.bench_serving._drive`` with the port's ``Request``."""
    submitted, idx = [], 0
    while idx < len(trace) or engine._work_pending():
        if engine.tick >= max_ticks:
            break
        while idx < len(trace) and trace[idx]["arrival"] <= engine.tick:
            spec = trace[idx]
            req = Request(rid=spec["rid"], prompt=list(spec["prompt"]),
                          max_tokens=spec["max_tokens"],
                          tenant=spec["tenant"], priority=spec["priority"],
                          ttl=spec["ttl"])
            engine.submit(req)
            submitted.append(req)
            idx += 1
        engine.step()
    engine.drain(max_ticks=max_ticks)
    return submitted


def _terminal_map(done):
    return {r.rid: (r.state.value, tuple(int(t) for t in r.output))
            for r in done}


@functools.lru_cache(maxsize=None)
def _served(paged: bool, use_kernels: bool = False, fault: str | None = None):
    rcfg, cfg, rmodel, rparams, params, _, _ = _setup("float32")
    trace = build_trace(n=12, seed=7)
    common = dict(max_slots=2, max_len=64, seed=3, paged_kv=paged,
                  page_size=16, watchdog_probation=2)
    with warnings.catch_warnings(record=True) as ref_warned:
        warnings.simplefilter("always")
        ref = RefEngine(rmodel, rparams,
                        admission=RefAdmission(policy="edf", preemption=True),
                        fault_plan=RefFaultPlan.parse(fault) if fault else None,
                        **common)
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        port = InferenceEngine(Model(cfg, use_kernels=use_kernels), params,
                               admission=AdmissionConfig(policy="edf",
                                                         preemption=True),
                               fault_plan=FaultPlan.parse(fault) if fault
                               else None, **common)
    ref_msgs = [str(w.message) for w in ref_warned
                if issubclass(w.category, RefDegradationWarning)]
    msgs = [str(w.message) for w in warned
            if issubclass(w.category, DegradationWarning)]
    return ((ref, _terminal_map(ref_drive(ref, trace)), ref_msgs),
            (port, _terminal_map(_drive(port, trace)), msgs))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_rwkv_engine_matches_reference_on_overload_trace(paged):
    (ref, ref_done, ref_msgs), (port, port_done, msgs) = _served(paged)
    assert port_done == ref_done
    assert port.fault_stats == ref.fault_stats
    assert port.tick == ref.tick
    assert port.fault_stats["expired_requests"] >= 1
    assert port.paged is False and ref.paged is False
    # paged_kv=True degrades to the dense slab with the reference's warning
    assert msgs == ref_msgs and len(msgs) == int(paged)
    assert port.kv_cache_bytes() == sum(
        v.numel() * v.element_size() for v in port.caches[0].values())


def test_rwkv_decode_step_fault_reruns_the_step_from_the_kept_state():
    """The state is updated in place; a failed graph step must not advance
    it before the eager rung runs the step again (the JAX package's step is
    functional, so its eager rerun starts from the old state)."""
    with pytest.warns(UserWarning, match="decode watchdog"):
        (ref, ref_done, _), (port, port_done, _) = _served(
            False, fault="decode_step:raise:1")
    assert port_done == ref_done == _served(False)[1][1]
    assert port.fault_stats == ref.fault_stats
    assert port.fault_stats["watchdog_fallbacks"] == 1
    assert port.fault_stats["watchdog_probations"] == 1


def test_rwkv_kernel_route_engine_equals_plain_route():
    assert _served(False, True)[1][1] == _served(False)[1][1]


def test_calibrate_schedule_measures_the_wkv_scan(tmp_path):
    _, cfg, _, _, params, _, _ = _setup("float32")
    sess = Session(SessionConfig(device="cpu", hw=V5E,
                                 calib_dir=str(tmp_path)))
    engine = InferenceEngine(Model(cfg), params, max_slots=2, max_len=32,
                             session=sess)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DegradationWarning)
        plan = engine.calibrate_schedule(n_layers=2)
    assert plan is engine.schedule_plan
    assert any(n.name.endswith(".wkv_scan") for n in plan.graph)
    stats = sess.cache_stats()
    assert stats["calib_degraded_analytic"] == 0
    assert stats["calib_misses"] == 1


def test_serve_cli_runs_the_rwkv_smoke_config_on_the_cpu():
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-tokens", "4", "--calibrate"]) == 0
