"""The port's Hymba (hybrid attention ∥ Mamba) family against the JAX
package's.

Held on numpy-seeded inputs and on params drawn by the JAX ``init`` and
converted bit-exactly by ``repro_torch.bridge``:

* ``mamba_seq`` against ``repro.models.ssm.mamba_seq`` at odd T from a
  nonzero conv and scan state, and the port's one-update-a-step scan
  (``mamba_scan``) against the per-token loop of both packages;
* the hymba-1.5b smoke ``Model``: prefill and 3 decode steps on the plain
  route and on the kernel route, against the reference's plain route
  (ROADMAP C2: its kernel route drops the window).  The smoke window of 8
  and the 4 meta tokens both act on the 11-token prompt;
* the op graph node for node (names, kinds, ``fuse_sig``s, the lowered
  steps and ``program_stats()``) and its executed output against the JAX
  package's captured program;
* the serving engine on the overload trace against the reference engine,
  ``paged_kv=True`` degrading to the dense slab, and the watchdog's rerun
  from the kept Mamba state (no KV leaf copied).

Tolerances: fp32 1e-5; bf16 2e-2 relative L2 over the tensor, the JAX
package's bf16 differential tolerance.
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from benchmarks.bench_serving import _drive as ref_drive  # noqa: E402
from benchmarks.bench_serving import build_trace  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.scheduler import compile_plan as ref_compile  # noqa: E402
from repro.core.scheduler import schedule as ref_schedule  # noqa: E402
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
from repro_torch.core.scheduler import compile_plan, schedule  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.opgraph_export import build_lm_opgraph  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402
from repro_torch.runtime.faults import FaultPlan  # noqa: E402
from repro_torch.runtime.guard import DegradationWarning  # noqa: E402
from repro_torch.serving import (AdmissionConfig, InferenceEngine,  # noqa: E402
                                 Request)

ARCH = "hymba-1.5b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
PROMPT, CACHE = 11, 24


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


@functools.lru_cache(maxsize=None)
def _setup(dtype: str):
    jdt, tdt, _ = DTYPES[dtype]
    rcfg = dataclasses.replace(ref_config(ARCH, smoke=True), dtype=jdt)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=tdt)
    rmodel = RefModel(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, rcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    steps = rng.integers(1, rcfg.vocab_size, (3, 2)).astype(np.int32)
    return rcfg, cfg, rmodel, rparams, _tree(rparams), tokens, steps


def test_smoke_config_exercises_the_window_and_the_meta_tokens():
    cfg = get_config(ARCH, smoke=True)
    assert cfg.family == "hybrid" and cfg.meta_tokens == 4
    assert cfg.window == 8 < PROMPT + cfg.meta_tokens
    assert 1 not in cfg.global_layers and cfg.n_layers == 3
    full = get_config(ARCH)
    assert (full.window, full.global_layers, full.meta_tokens) == (
        1024, (0, 15, 31), 128)
    assert (full.ssm.state_dim, full.ssm.conv_dim, full.ssm.expand) == (
        16, 4, 2)


# -- the Mamba head -------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 7, 33])
def test_mamba_scan_equals_the_per_token_loop(t):
    rng = np.random.default_rng(t)
    b, di, n = 2, 24, 4
    delta = (rng.uniform(0.0, 2.0, (b, t, 1)) + 1e-4).astype(np.float32)
    xi = rng.standard_normal((b, t, di)).astype(np.float32)
    bmat, cmat = [rng.standard_normal((b, t, n)).astype(np.float32)
                  for _ in range(2)]
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1))
    h0 = rng.standard_normal((b, di, n)).astype(np.float32)
    args = [torch.from_numpy(v) for v in (delta, xi, bmat, cmat, a, h0)]
    h, y = ssm.mamba_scan(*args)
    h_loop, y_loop = ssm.mamba_scan_ref(*args)
    rh, ry = ref_ssm.mamba_scan_ref(*[jnp.asarray(v) for v in
                                      (delta, xi, bmat, cmat, a, h0)])
    for got, want in ((h, h_loop), (y, y_loop), (h, rh), (y, ry)):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mamba_seq_matches_reference_from_a_nonzero_state(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rcfg, cfg, _, rparams, params, _, _ = _setup(dtype)
    rp = jax.tree_util.tree_map(lambda a: a[1], rparams["stacks"][0]["mamba"])
    p = layer_params(params["stacks"][0]["mamba"], 1)
    di = cfg.ssm.expand * cfg.d_model
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, cfg.ssm.conv_dim - 1, di)).astype(
        np.float32)
    h0 = rng.standard_normal((2, di, cfg.ssm.state_dim)).astype(np.float32)
    ry, (rconv, rh) = ref_ssm.mamba_seq(
        rp, jnp.asarray(x, jdt), (jnp.asarray(conv, jdt), jnp.asarray(h0)),
        rcfg)
    y, (tconv, th) = ssm.mamba_seq(
        p, torch.from_numpy(x).to(tdt),
        (torch.from_numpy(conv).to(tdt), torch.from_numpy(h0)), cfg)
    assert tconv.dtype == tdt and th.dtype == torch.float32
    _close(y, ry, tol)
    _close(tconv, rconv, tol)
    _close(th, rh, tol)


# -- the op graph's scan stage (kernels/mamba_scan) -------------------------------------

def _scan_stage_case(t, di=24, n=4, b=2):
    rng = np.random.default_rng(100 + t)
    packed = rng.standard_normal((b, t, 2 * di + 2 * n + 1)).astype(
        np.float32)
    packed[:, ::3, -1] += 21.0           # past softplus's threshold
    a_log = rng.uniform(-1.5, 2.5, (di, n)).astype(np.float32)
    d_skip = rng.standard_normal(di).astype(np.float32)
    return [torch.from_numpy(v) for v in (packed, a_log, d_skip)]


@pytest.mark.parametrize("t", [1, 7, 33])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mamba_scan_cpu_route_matches_the_reference_scan_payload(dtype, t):
    """The scan stage's CPU route against the JAX package's scan payload on
    the same inputs, and the op graph's scan node runs that route."""
    from repro.models.opgraph_export import _mamba_scan_payload
    from repro_torch.kernels.mamba_scan import mamba_scan_stage, ops
    jdt, tdt, tol = DTYPES[dtype]
    packed, a_log, d_skip = _scan_stage_case(t)
    before = ops.launches
    got = mamba_scan_stage(packed.to(tdt), a_log, d_skip)
    assert ops.launches == before          # the CPU route counts nothing
    assert got.dtype == tdt and got.shape == (2, t, 24)
    want = _mamba_scan_payload(jnp.asarray(packed.numpy(), jdt),
                               jnp.asarray(a_log.numpy()),
                               jnp.asarray(d_skip.numpy()))
    _close(got, want, tol)
    _, cfg, _, _, params, _, _ = _setup(dtype)
    graph = build_lm_opgraph(cfg, batch=1, seq=4, params=params)
    scans = [n for n in graph if n.name.endswith(".mamba_scan")]
    assert scans and all(n.fn is mamba_scan_stage for n in scans)


@pytest.mark.parametrize("bad,error,match", [
    (lambda p, a, d: (p[0], a, d), ValueError, "packed"),
    (lambda p, a, d: (p[..., :-1], a, d), ValueError, "2·di"),
    (lambda p, a, d: (p, a, d[:-1]), ValueError, "d_skip"),
    (lambda p, a, d: (p, a[0], d), ValueError, "a_log"),
    (lambda p, a, d: (p.half(), a, d), TypeError, "bf16 or fp32"),
    (lambda p, a, d: (p.double(), a, d), TypeError, "bf16 or fp32"),
    (lambda p, a, d: (p, a.bfloat16(), d), TypeError, "fp32 a_log"),
    (lambda p, a, d: (p, a, d.double()), TypeError, "fp32 a_log"),
], ids=["packed_2d", "packed_width", "d_skip_len", "a_log_1d", "packed_fp16",
        "packed_fp64", "a_log_bf16", "d_skip_fp64"])
def test_mamba_scan_checks_raise_on_the_cpu(bad, error, match):
    from repro_torch.kernels.mamba_scan import mamba_scan_stage
    with pytest.raises(error, match=match):
        mamba_scan_stage(*bad(*_scan_stage_case(5)))


def test_launch_counts_have_the_mamba_scan_kernel():
    import sys
    capture = sys.modules["repro_torch.core.capture"]
    from repro_torch.kernels.mamba_scan import ops
    counts = capture._launch_counts()
    assert counts["mamba_scan"] == ops.launches


# -- the model facade -----------------------------------------------------------------

def test_hymba_init_matches_the_reference_tree():
    _, cfg, _, rparams, params, _, _ = _setup("bfloat16")
    ours = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")

    def walk(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype

    walk(ours, params)
    assert tuple(ours["meta"].shape) == (cfg.meta_tokens, cfg.d_model)
    assert ours["stacks"][0]["mamba"]["a_log"].dtype == torch.float32


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_hymba_prefill_and_decode_match_reference(dtype, use_kernels):
    _, _, tol = DTYPES[dtype]
    rcfg, cfg, rmodel, rparams, params, tokens, steps = _setup(dtype)
    model = Model(cfg, use_kernels=use_kernels)
    r_logits, r_caches = rmodel.prefill(rparams,
                                        {"tokens": jnp.asarray(tokens)},
                                        cache_len=CACHE)
    logits, caches = model.prefill(
        params, {"tokens": torch.from_numpy(tokens).long()}, cache_len=CACHE)
    _close(logits, r_logits, tol)
    assert sorted(caches[0]) == sorted(r_caches[0]) == ["kv", "mamba_conv",
                                                        "mamba_h"]
    # KV is padded to the cache length; the Mamba state passes through
    for got, want in zip(caches[0]["kv"], r_caches[0]["kv"]):
        assert tuple(got.shape) == want.shape == (3, 2, CACHE, 2, 16)
        _close(got, want, tol)
    for key in ("mamba_conv", "mamba_h"):
        assert tuple(caches[0][key].shape) == r_caches[0][key].shape
        _close(caches[0][key], r_caches[0][key], tol)
    ptrs = [t.data_ptr() for t in (*caches[0]["kv"], caches[0]["mamba_conv"],
                                   caches[0]["mamba_h"])]
    for i, tok in enumerate(steps):
        pos = np.full((2,), PROMPT + i, np.int32)
        r_logits, r_caches = rmodel.decode(rparams, jnp.asarray(tok),
                                           r_caches, jnp.asarray(pos))
        logits, caches = model.decode(params, torch.from_numpy(tok).long(),
                                      caches, torch.from_numpy(pos))
        _close(logits, r_logits, tol)
    # decode wrote every leaf in place
    assert ptrs == [t.data_ptr() for t in (*caches[0]["kv"],
                                           caches[0]["mamba_conv"],
                                           caches[0]["mamba_h"])]
    _close(caches[0]["mamba_h"], r_caches[0]["mamba_h"], tol)
    _close(caches[0]["kv"][0], r_caches[0]["kv"][0], tol)


def test_window_and_meta_tokens_change_the_logits():
    """Neither feature is a no-op on the smoke prompt: dropping the window
    or zeroing the meta rows moves the prefill logits."""
    _, cfg, _, _, params, tokens, _ = _setup("float32")
    tok = {"tokens": torch.from_numpy(tokens).long()}
    base = Model(cfg).prefill(params, tok)[0]
    unwindowed = Model(dataclasses.replace(cfg, window=None)).prefill(
        params, tok)[0]
    no_meta = Model(cfg).prefill({**params, "meta": params["meta"] * 0},
                                 tok)[0]
    assert float((base - unwindowed).abs().max()) > 1e-3
    assert float((base - no_meta).abs().max()) > 1e-3


def test_paged_caches_refuse_the_hybrid_stack():
    _, cfg, *_ = _setup("float32")
    assert not Model(cfg).supports_paged()
    with pytest.raises(ValueError, match="recurrent state"):
        Model(cfg).init_paged_caches(8, 4, "cpu")


# -- the op graph ------------------------------------------------------------------------

def _steps(exe):
    return [(s.route, tuple(s.op_ids), tuple(s.group_sizes),
             tuple(s.free_slots), tuple(s.out_slots), tuple(s.arg_slots))
            for s in exe.steps]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_hymba_op_graph_matches_reference(dtype, tmp_path):
    _, _, tol = DTYPES[dtype]
    rcfg, cfg, _, rparams, params, _, _ = _setup(dtype)
    rg = ref_export(rcfg, batch=2, seq=12, params=rparams)
    pg = build_lm_opgraph(cfg, batch=2, seq=12, params=params)
    assert [n.name for n in pg] == [n.name for n in rg]
    assert [n.kind.value for n in pg] == [n.kind.value for n in rg]
    assert [n.fuse_sig for n in pg] == [n.fuse_sig for n in rg]
    assert pg.node_signature() == rg.node_signature()
    assert sum(n.name.endswith(".mamba_scan") for n in pg) == cfg.n_layers
    xproj = [n for n in pg if n.name.endswith(".mamba_xproj")]
    assert xproj and all(n.meta.get("payload") is None for n in xproj)
    rexe = ref_compile(ref_schedule(rg, "opara", "opara"),
                       gemm_kernel="pallas")
    pexe = compile_plan(schedule(pg, "opara", "opara"), gemm_kernel="kernel")
    assert _steps(pexe) == _steps(rexe)
    assert pexe.program_stats() == rexe.program_stats()
    sess = Session(SessionConfig(device="cpu", hw=V5E,
                                 calib_dir=str(tmp_path)))
    tok = np.random.default_rng(5).integers(0, rcfg.vocab_size,
                                            (2, 12)).astype(np.int32)
    model = sess.compile(pg, inputs={0: torch.from_numpy(tok).long()})
    assert model.executable.program_stats()["n_branch_gemm"] >= 1
    got = model({"tokens": torch.from_numpy(tok)})
    want = rexe({"tokens": jnp.asarray(tok)})
    _close(got[-1], want[-1], tol)
    seq = run_sequential_uncompiled(pg, {"tokens": torch.from_numpy(tok)},
                                    model.executable.output_ids)
    _close(got[-1], seq[-1], tol)


def test_hymba_cost_only_export_matches_reference_at_full_width():
    rg = ref_export(ref_config(ARCH), batch=1, seq=64, n_layers=3)
    pg = build_lm_opgraph(get_config(ARCH), batch=1, seq=64, n_layers=3)
    assert [n.name for n in pg] == [n.name for n in rg]
    assert pg.node_signature() == rg.node_signature()


# -- serving -----------------------------------------------------------------------------

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


def _port_engine(paged: bool = False, use_kernels: bool = False,
                 fault: str | None = None):
    _, cfg, _, _, params, _, _ = _setup("float32")
    return InferenceEngine(Model(cfg, use_kernels=use_kernels), params,
                           admission=AdmissionConfig(policy="edf",
                                                     preemption=True),
                           fault_plan=FaultPlan.parse(fault) if fault
                           else None, max_slots=2, max_len=64, seed=3,
                           paged_kv=paged, page_size=16,
                           watchdog_probation=2)


@functools.lru_cache(maxsize=None)
def _served(paged: bool, use_kernels: bool = False, fault: str | None = None):
    _, _, rmodel, rparams, _, _, _ = _setup("float32")
    trace = build_trace(n=12, seed=7)
    with warnings.catch_warnings(record=True) as ref_warned:
        warnings.simplefilter("always")
        ref = RefEngine(rmodel, rparams,
                        admission=RefAdmission(policy="edf", preemption=True),
                        fault_plan=RefFaultPlan.parse(fault) if fault else None,
                        max_slots=2, max_len=64, seed=3, paged_kv=paged,
                        page_size=16, watchdog_probation=2)
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        port = _port_engine(paged, use_kernels, fault)
    ref_msgs = [str(w.message) for w in ref_warned
                if issubclass(w.category, RefDegradationWarning)]
    msgs = [str(w.message) for w in warned
            if issubclass(w.category, DegradationWarning)]
    return ((ref, _terminal_map(ref_drive(ref, trace)), ref_msgs),
            (port, _terminal_map(_drive(port, trace)), msgs))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_hymba_engine_matches_reference_on_overload_trace(paged):
    (ref, ref_done, ref_msgs), (port, port_done, msgs) = _served(paged)
    assert port_done == ref_done
    assert port.fault_stats == ref.fault_stats
    assert port.tick == ref.tick
    assert port.paged is False and ref.paged is False
    # paged_kv=True degrades to the dense slab with the reference's warning
    assert msgs == ref_msgs and len(msgs) == int(paged)
    stack = port.caches[0]
    assert sorted(stack) == ["kv", "mamba_conv", "mamba_h"]
    assert stack["kv"][0].shape[2] == 64 + port.cfg.meta_tokens


def test_hymba_kernel_route_engine_equals_plain_route():
    assert _served(False, True)[1][1] == _served(False)[1][1]


def test_hybrid_decode_step_fault_reruns_the_step_from_the_kept_state(
        monkeypatch):
    """A failed graph step has already advanced the Mamba state in place;
    the eager rung must rerun the step from the kept copy.  Only the
    recurrent leaves are kept: a KV write is idempotent."""
    engine = _port_engine()
    kv_shapes = {tuple(t.shape) for t in engine.caches[0]["kv"]}
    assert [tuple(t.shape) for t in engine._state_leaves] == [
        tuple(engine.caches[0][k].shape) for k in ("mamba_conv", "mamba_h")]
    cloned = []
    clone = torch.Tensor.clone

    def recording_clone(self, *args, **kwargs):
        cloned.append(tuple(self.shape))
        return clone(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "clone", recording_clone)
    with pytest.warns(UserWarning, match="decode watchdog"):
        (ref, ref_done, _), (port, port_done, _) = _served(
            False, fault="decode_step:raise:1")
    monkeypatch.undo()
    assert port_done == ref_done == _served(False)[1][1]
    assert port.fault_stats == ref.fault_stats
    assert port.fault_stats["watchdog_fallbacks"] == 1
    assert cloned and not kv_shapes & set(cloned)


def test_serve_cli_runs_the_hymba_smoke_config_on_the_cpu():
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-tokens", "4", "--calibrate"]) == 0
