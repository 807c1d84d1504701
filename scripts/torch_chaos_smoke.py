"""Chaos smoke of the PyTorch/CUDA port: the differential harness, once per
injection site.

The port of ``scripts/chaos_smoke.py``: the same 14 scenarios in the same
order, on ``repro_torch`` alone.  Each scenario arms a fresh
:class:`~repro_torch.runtime.faults.FaultPlan` parsed from its spec —
process-wide through ``faults.activate`` for the graph sites (the plan that
``$REPRO_TORCH_FAULT_PLAN`` would arm), so that leaving the context disarms
it around the same Session; per engine (``InferenceEngine(fault_plan=)``)
for the serving sites — and checks the port's contract
(``docs/torch_robustness.md``):

* a site with a slower rung: the outputs equal the fault-free ground truth
  (per-op sequential execution of the graph; the engine's fault-free run of
  the same trace) and the degradation is reported (``cache_stats()``,
  ``explain()["degraded"]``, ``fault_stats``, a FAILED / SHED / EXPIRED
  request); every warning and event of the run names the injected fault,
  so a real error cannot pass as the injected one;
* a fused-route site (``kernel_compile``, ``grouped_gemm_route``), where
  the port keeps no slower rung: ``Session.compile`` raises
  ``FaultInjected`` naming the site while lowering, before any CUDA graph is
  recorded, and caches nothing; disarmed, the same session compiles the
  kernel route, caches it and matches the ground truth; and a replay that
  fails at call time propagates instead of being rescued.

Sizes: ``--size smoke`` runs the JAX script's shapes (a 3-branch graph at
d 64, a ragged (8, 24, 16) group at K = F = 128, GLM-4-9B's smoke config at
2 layers, Llama-3.2-1B's smoke config, prompts of 3-4 tokens, 4 output
tokens, ``max_len`` 32, 4-position pages); ``--size full`` (the default on
the card) runs Qwen2-0.5B's full-depth op graph (bf16, batch 1, seq 512),
a ragged group at Kimi-K2's expert widths (K 7168, F 2048, M 8 / 24 / 16,
bf16), GLM-4-9B at full width and 2 layers in fp32 (seq 512) and
Llama-3.2-1B at full width and depth in fp32 behind
``Model(use_kernels=True)`` (prompts of 32-256 tokens, 16 output tokens,
``max_len`` 512, 16-position pages; the traces' deadlines scale with the
output length).  Each site logs what its rung cost beside the fault-free
run: compile and replay ms for a graph, run and tick ms for an engine.

    PYTHONPATH=src python scripts/torch_chaos_smoke.py --device cpu
    PYTHONPATH=src python scripts/torch_chaos_smoke.py      # the card, full

Prints one ``[chaos] <spec> ok ...`` line per site and ``[chaos] N/14 sites
clean``; the exit status is non-zero if any site breaks the contract.
Without a CUDA card ``--device cuda`` (the default) raises.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import statistics
import sys
import tempfile
import threading
import time
import traceback
import warnings
from typing import Any, Callable

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import serving as port_serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (H100_SXM, Session, SessionConfig,  # noqa: E402
                              run_sequential_uncompiled)
from repro_torch.core.graph import OpGraph, OpKind  # noqa: E402
from repro_torch.core.profiler import (ProfileTable, detach_profile,  # noqa: E402
                                       gemm_cost)
from repro_torch.core.session import (_calib_disk_load,  # noqa: E402
                                      _calib_disk_store)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.opgraph_export import build_lm_opgraph  # noqa: E402
from repro_torch.runtime.faults import (FaultInjected, FaultPlan,  # noqa: E402
                                        activate)
from repro_torch.runtime.guard import DegradationWarning  # noqa: E402
from repro_torch.serving import RequestState, TERMINAL_STATES  # noqa: E402

# =============================================================================
# agreement rules: the tolerances of the kernel and op-graph gates, defined
# here once (chip_smoke.py takes them from this file)
# =============================================================================

# Kernel vs plain, bf16: both accumulate in fp32 and round once to bf16, so
# they differ by at most about one bf16 ulp (2^-8 relative).
BF16_TOL = 1e-2                 # atol = rtol
# Kernel vs plain, fp32 (TF32 off on both sides): summation order only.
FP32_TOL = 1e-5                 # relative to max|plain|
# Main path vs eager per-op execution: the same payloads, except that the
# fused GEMMs replace per-op cuBLAS calls.  Both accumulate in fp32 and round
# once to bf16, but need not sum in the same order, so a bf16 activation
# may differ by an ulp and the difference runs through every layer.  The
# bound is the JAX package's bf16 differential tolerance, kept although
# H100 runs have given bit-equal logits, because nothing guarantees
# cuBLAS's summation order.  The kernel route (use_kernels=True) is held to
# the plain route by the same two numbers: relative L2 in bf16 and fp32,
# top-1 agreement in fp32 (and on op graphs) only.
LOGITS_REL_L2 = 2e-2
TOP1_AGREE = 0.99               # greedy tokens equal on >= 99% of positions


def check_close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Hold ``got`` against ``want`` at the dtype's tolerance; returns the
    max abs error."""
    err = (got.float() - want.float()).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if got.dtype == torch.bfloat16:
        bad = err > BF16_TOL + BF16_TOL * want.float().abs()
        if bool(bad.any()):
            raise AssertionError(f"{what}: {int(bad.sum())} elements off "
                                 f"by more than {BF16_TOL} (max {max_err})")
    else:
        scale = float(want.float().abs().max()) if want.numel() else 0.0
        if max_err > FP32_TOL * max(scale, 1e-30):
            raise AssertionError(f"{what}: max err {max_err} > {FP32_TOL} "
                                 f"x max|ref| {scale}")
    return max_err


def agreement(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """Relative L2 distance of two logit tensors and the share of positions
    whose greedy tokens agree."""
    got, want = got.float(), want.float()
    rel = float((got - want).norm() / want.norm())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return rel, agree


def agree_allclose(got: list, want: list, what: str) -> str:
    """fp32 at smoke size: the JAX script's rule, rtol = atol = 1e-5."""
    worst = 0.0
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=what)
        worst = max(worst, float((a.float() - b.float()).abs().max()))
    return f"max_abs_err {worst:.3g} (rtol = atol = 1e-5)"


def agree_close(got: list, want: list, what: str) -> str:
    """Outputs at full width, by :func:`check_close`: bf16 element-wise
    within ``BF16_TOL`` + ``BF16_TOL`` |ref|, fp32 within ``FP32_TOL`` x
    max |ref|."""
    worst = max(check_close(a, b, what)
                for a, b in zip(got, want, strict=True))
    rule = (f"<= {BF16_TOL} + {BF16_TOL} |ref|"
            if got[0].dtype == torch.bfloat16 else f"<= {FP32_TOL} x max|ref|")
    return f"max_abs_err {worst:.3g} ({rule})"


def agree_logits(got: list, want: list, what: str) -> str:
    """Logits of a deep bf16 op graph: relative L2 <= ``LOGITS_REL_L2`` and
    greedy tokens equal on >= ``TOP1_AGREE`` of positions (the op-graph
    gate)."""
    parts = []
    for a, b in zip(got, want, strict=True):
        rel, agree = agreement(a, b)
        if (not bool(torch.isfinite(a.float()).all()) or rel > LOGITS_REL_L2
                or agree < TOP1_AGREE):
            raise AssertionError(f"{what}: rel_l2 {rel:.3e} (<= "
                                 f"{LOGITS_REL_L2}), top1 {agree:.4f} (>= "
                                 f"{TOP1_AGREE})")
        parts.append(f"rel_l2 {rel:.3e} top1 {agree:.4f}")
    return (f"{'; '.join(parts)} (rel_l2 <= {LOGITS_REL_L2}, top1 >= "
            f"{TOP1_AGREE})")


# =============================================================================
# graphs and models
# =============================================================================

def _mm(x, w):
    return x @ w


def _sum(*xs):
    return sum(xs)


def build_branchy_graph(device, width: int = 3, d: int = 64, tokens: int = 8,
                        seed: int = 0) -> OpGraph:
    """Stackable parallel-matmul DAG (the Inception motivation shape), the
    JAX script's ``build_branchy_graph``."""
    rng = np.random.default_rng(seed)
    g = OpGraph("chaos")
    inp = g.add("x", OpKind.INPUT, out_shape=(tokens, d))
    outs = []
    for b in range(width):
        w = torch.tensor(rng.standard_normal((d, d)) * 0.05,
                         dtype=torch.float32, device=device)
        outs.append(g.add(f"gemm{b}", OpKind.GEMM, [inp], fn=_mm,
                          cost=gemm_cost(tokens, d, d, 4),
                          fuse_sig=("gemm", tokens, d, d), consts=(w,),
                          payload="matmul"))
    g.add("sum", OpKind.ELEMENTWISE, outs, fn=_sum)
    g.validate()
    return g


def build_ragged_graph(device, sizes=(8, 24, 16), k: int = 128, f: int = 128,
                       dtype=torch.float32, seed: int = 3) -> OpGraph:
    """Ragged-M matmul fan-out (the MoE expert shape, grouped-GEMM route),
    the JAX script's ``build_ragged_graph``."""
    rng = np.random.default_rng(seed)
    g = OpGraph("chaos-ragged")
    for i, m in enumerate(sizes):
        x = g.add(f"x{i}", OpKind.INPUT, out_shape=(m, k), out_dtype=dtype)
        w = torch.tensor(rng.standard_normal((k, f)) * k ** -0.5,
                         dtype=torch.float32).to(device=device, dtype=dtype)
        g.add(f"gemm{i}", OpKind.GEMM, [x], fn=_mm,
              cost=gemm_cost(m, k, f, 4), fuse_sig=("gemm", k, f),
              consts=(w,), payload="matmul", out_shape=(m, f),
              out_dtype=dtype)
    g.validate()
    return g


def _graph_inputs(g: OpGraph, device, seed: int = 9) -> dict:
    rng = np.random.default_rng(seed)
    return {n.name: torch.tensor(rng.standard_normal(n.out_shape) * 0.1,
                                 dtype=torch.float32).to(
                                     device=device,
                                     dtype=n.out_dtype or torch.float32)
            for n in g if n.fn is None}


def _lm_case(arch: str, smoke: bool, device, dtype, seed: int, batch: int,
             seq: int, n_layers: int | None = None,
             tokens: list[list[int]] | None = None):
    """An LM op graph (``build_lm_opgraph``) at ``arch``'s widths (its smoke
    config's with ``smoke``), depth cut to ``n_layers``, random weights from
    ``seed``, and one token batch (random unless ``tokens`` is given)."""
    cfg = dataclasses.replace(get_config(arch, smoke=smoke), dtype=dtype)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = Model(cfg).init(gen, device)
    g = build_lm_opgraph(cfg, batch=batch, seq=seq, params=params)
    if tokens is None:
        tok = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                            device=device)
    else:
        tok = torch.tensor(tokens, dtype=torch.long, device=device)
    return g, {"tokens": tok}


@dataclasses.dataclass
class GraphCase:
    """One graph with its inputs and the rule its outputs are held to."""

    graph: OpGraph
    inputs: dict                          # by INPUT node name
    agree: Callable[[list, list, str], str]
    kernel: str                           # the fused route its groups take
    what: str

    @property
    def calib(self) -> dict:              # profiling inputs by op id
        return {n.op_id: self.inputs[n.name] for n in self.graph
                if n.fn is None}


@dataclasses.dataclass(frozen=True)
class TraceShape:
    """Sizes of the serving traces.  With ``prompt_lens`` None the prompts
    are the JAX script's (3-4 small token ids); otherwise each is drawn from
    ``seed`` with a length in ``prompt_lens``.  Deadlines and tick budgets
    scale with ``max_tokens`` (the JAX script's are for 4)."""

    max_len: int = 32
    max_tokens: int = 4
    page_size: int = 4
    prompt_lens: tuple[int, int] | None = None
    vocab: int = 0
    seed: int = 0

    @property
    def scale(self) -> int:
        return max(1, self.max_tokens // 4)

    def prompt(self, salt: int, rid: int, tokens: list[int]) -> list[int]:
        if self.prompt_lens is None:
            return list(tokens)
        rng = np.random.default_rng([self.seed, salt, rid])
        n = int(rng.integers(self.prompt_lens[0], self.prompt_lens[1] + 1))
        return rng.integers(1, self.vocab, n).tolist()


class Setup:
    """What one chaos run runs on: the device, the sizes, the calibration
    directory, and (built on first use, then shared by the scenarios) the
    graphs, the serving model and the fault-free runs."""

    def __init__(self, device: str | torch.device = "cpu", size: str = "smoke",
                 seed: int = 0, calib_dir: str | None = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the chaos smoke runs on the CUDA card and none "
                               "is present; pass --device cpu")
        if size not in ("smoke", "full"):
            raise ValueError(f"unknown size {size!r}")
        self.size, self.seed = size, seed
        self._tmp = None
        if calib_dir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="chaos-calib-")
            calib_dir = self._tmp.name
        self.calib_dir = calib_dir
        self._cases: dict[str, GraphCase] = {}
        self._clean_builds: dict[str, dict] = {}
        self._clean_runs: dict[str, tuple] = {}
        self._serve = None

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def close(self) -> None:
        if self._tmp is not None:
            self._tmp.cleanup()

    # -- graphs ---------------------------------------------------------------
    def graph_case(self, name: str) -> GraphCase:
        """Graph ``name`` on analytic costs, as freshly built (a build
        calibrated by an earlier scenario leaves its timings on the graph)."""
        if name not in self._cases:
            self._cases[name] = self._build_case(name)
        detach_profile(self._cases[name].graph)
        return self._cases[name]

    def _build_case(self, name: str) -> GraphCase:
        dev, full = self.device, self.size == "full"
        if name == "branchy":
            if full:
                g, inputs = _lm_case("qwen2-0.5b", False, dev, torch.bfloat16,
                                     self.seed, 1, 512)
                return GraphCase(g, inputs, agree_logits, "branch_gemm",
                                 "qwen2-0.5b 24 layers bf16 batch 1 seq 512")
            g = build_branchy_graph(dev)
            return GraphCase(g, _graph_inputs(g, dev), agree_allclose,
                             "branch_gemm", "3 branches d 64 fp32")
        if name == "ragged":
            if full:
                g = build_ragged_graph(dev, (8, 24, 16), 7168, 2048,
                                       torch.bfloat16, seed=self.seed + 3)
                return GraphCase(g, _graph_inputs(g, dev), agree_close,
                                 "grouped_gemm",
                                 "ragged M 8/24/16 K 7168 F 2048 bf16")
            g = build_ragged_graph(dev)
            return GraphCase(g, _graph_inputs(g, dev), agree_allclose,
                             "grouped_gemm", "ragged M 8/24/16 K 128 F 128 fp32")
        if name == "arch":
            if full:
                g, inputs = _lm_case("glm4-9b", False, dev, torch.float32,
                                     self.seed, 1, 512, n_layers=2)
                return GraphCase(g, inputs, agree_close, "branch_gemm",
                                 "glm4-9b 2 layers fp32 batch 1 seq 512")
            g, inputs = _lm_case("glm4-9b", True, dev, torch.float32, 0, 1, 4,
                                 n_layers=2, tokens=[[3, 1, 4, 1]])
            return GraphCase(g, inputs, agree_allclose, "branch_gemm",
                             "glm4-9b smoke 2 layers fp32 seq 4")
        raise KeyError(name)

    def session_config(self, calib_dir: str, **kw) -> SessionConfig:
        return SessionConfig(device=self.device.type,
                             hw=None if self.cuda else H100_SXM,
                             calib_dir=calib_dir, gemm_kernel="kernel", **kw)

    def clean_build(self, name: str) -> dict:
        """The fault-free build of graph ``name`` (calibrated, in a fresh
        session and disk tier): compile ms and replay ms."""
        if name not in self._clean_builds:
            case = self.graph_case(name)
            sess = Session(self.session_config(
                os.path.join(self.calib_dir, f"clean-{name}")))
            t0 = time.perf_counter()
            model = sess.compile(case.graph, inputs=case.calib)
            model(case.inputs)
            self.sync()
            compile_ms = (time.perf_counter() - t0) * 1e3
            self._clean_builds[name] = {
                "compile_ms": compile_ms,
                "replay_ms": self.timed_ms(lambda: model(case.inputs))}
        return self._clean_builds[name]

    # -- serving ----------------------------------------------------------------
    def serve_model(self):
        """(model, params, trace shape) of the serving scenarios."""
        if self._serve is None:
            full = self.size == "full"
            cfg = dataclasses.replace(
                get_config("llama3.2-1b", smoke=not full), dtype=torch.float32)
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            params = Model(cfg).init(gen, self.device)
            shape = (TraceShape(max_len=512, max_tokens=16, page_size=16,
                                prompt_lens=(32, 256), vocab=cfg.vocab_size,
                                seed=self.seed)
                     if full else TraceShape())
            self._serve = (Model(cfg, use_kernels=True), params, shape)
        return self._serve

    def run_trace(self, trace: str, fault_plan: FaultPlan | None = None,
                  **engine_kw) -> tuple[Any, dict, float]:
        """One run of ``trace`` on the port's engine: (engine, {rid:
        request}, run ms)."""
        model, params, shape = self.serve_model()
        t0 = time.perf_counter()
        engine, done = TRACES[trace](port_serving, model, params, shape,
                                     fault_plan=fault_plan, **engine_kw)
        self.sync()
        return engine, done, (time.perf_counter() - t0) * 1e3

    def clean_run(self, trace: str) -> tuple[Any, dict, float]:
        if trace not in self._clean_runs:
            self._clean_runs[trace] = self.run_trace(trace)
        return self._clean_runs[trace]

    # -- timing -------------------------------------------------------------------
    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def timed_ms(self, fn: Callable[[], Any], iters: int = 10,
                 warmup: int = 2) -> float:
        """Median ms of ``fn`` (CUDA events on the card, the host clock on
        the CPU)."""
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)


# =============================================================================
# serving traces (shared with the tests, which also run them on the JAX
# package's engine: ``api`` is a serving package, ``repro_torch.serving`` or
# its reference)
# =============================================================================

def decode_batch_run(api, model, params, shape: TraceShape, fault_plan=None,
                     **engine_kw):
    """Three co-batched requests (the JAX script's ``check_engine_site``)."""
    engine = api.InferenceEngine(model, params, max_slots=3,
                                 max_len=shape.max_len, fault_plan=fault_plan,
                                 **engine_kw)
    reqs = [api.Request(rid=rid, prompt=shape.prompt(0, rid, [1 + rid, 2, 3]),
                        max_tokens=shape.max_tokens) for rid in range(3)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return engine, {r.rid: r for r in reqs}


def overload_run(api, model, params, shape: TraceShape, fault_plan=None,
                 **engine_kw):
    """Burst trace: 7 requests at once, 2 slots, a queue of 3, a tenant
    quota of 2, three tenants, mixed priorities and deadlines."""
    s = shape.scale
    engine = api.InferenceEngine(
        model, params, max_slots=2, max_len=shape.max_len,
        admission=api.AdmissionConfig(max_queue=3, tenant_quota=2),
        fault_plan=fault_plan, **engine_kw)
    reqs = [api.Request(rid=rid, prompt=shape.prompt(1, rid, [1 + rid, 2, 3]),
                        max_tokens=shape.max_tokens, tenant=f"t{rid % 3}",
                        priority=rid % 2,
                        ttl=s * (10 + 2 * rid) if rid % 2 else None)
            for rid in range(7)]
    for r in reqs:
        engine.submit(r)
    engine.run(max_ticks=64 * s)
    return engine, {r.rid: r for r in reqs}


def preempt_run(api, model, params, shape: TraceShape, fault_plan=None,
                **engine_kw):
    """One slot: a batch request runs, then a deadline-critical request of
    higher priority arrives (due one tick after it could still finish)."""
    engine = api.InferenceEngine(model, params, max_slots=1,
                                 max_len=shape.max_len,
                                 admission=api.AdmissionConfig(),
                                 fault_plan=fault_plan, **engine_kw)
    batch = api.Request(rid=0, prompt=shape.prompt(2, 0, [1, 2, 3]),
                        max_tokens=2 * shape.max_tokens, priority=0)
    engine.submit(batch)
    engine.step()                          # batch takes the only slot
    prod = api.Request(rid=1, prompt=shape.prompt(2, 1, [4, 5, 6]),
                       max_tokens=shape.max_tokens, priority=2,
                       ttl=shape.max_tokens + 2)
    engine.submit(prod)
    engine.run(max_ticks=64 * shape.scale)
    return engine, {0: batch, 1: prod}


def paged_run(api, model, params, shape: TraceShape, fault_plan=None,
              **engine_kw):
    """Burst trace against the paged-KV engine: 6 requests at once, 2
    slots, every request over several pages, preemption on."""
    s = shape.scale
    engine = api.InferenceEngine(
        model, params, max_slots=2, max_len=shape.max_len,
        admission=api.AdmissionConfig(max_queue=4, preemption=True),
        paged_kv=True, page_size=shape.page_size, fault_plan=fault_plan,
        **engine_kw)
    reqs = [api.Request(rid=rid, prompt=shape.prompt(3, rid,
                                                     [1 + rid, 2, 3, 4]),
                        max_tokens=shape.max_tokens, tenant=f"t{rid % 2}",
                        priority=rid % 3,
                        ttl=s * (12 + 2 * rid) if rid % 2 else None)
            for rid in range(6)]
    for r in reqs:
        engine.submit(r)
    engine.run(max_ticks=64 * s)
    return engine, {r.rid: r for r in reqs}


TRACES = {"decode_batch": decode_batch_run, "overload": overload_run,
          "preempt": preempt_run, "paged": paged_run}

# the fault_stats counter each serving site increments
SITE_COUNTER = {"admission_enqueue": "admission_faults",
                "deadline_check": "deadline_faults",
                "slot_preempt": "preempt_faults",
                "page_alloc": "page_alloc_faults",
                "block_table_build": "block_table_faults",
                "page_release": "page_release_faults"}


# =============================================================================
# contract checks on the port's results (the tests call them too)
# =============================================================================

def _site(spec: str) -> str:
    return spec.split(":")[0]


def check_all_terminal(engine, done: dict, site: str) -> None:
    for r in done.values():
        if r.state not in TERMINAL_STATES:
            raise AssertionError(f"site={site}: rid={r.rid} stranded in "
                                 f"{r.state}")
    if len(engine.admission):
        raise AssertionError(f"site={site}: queue not drained")
    if any(s is not None for s in engine.slots):
        raise AssertionError(f"site={site}: slot not released")


def check_done_streams(done: dict, clean: dict, site: str) -> int:
    """Every request DONE in both runs emitted the same tokens (greedy
    decode is schedule-independent); returns how many were compared."""
    n = 0
    for rid, r in done.items():
        if r.state is RequestState.DONE \
                and clean[rid].state is RequestState.DONE:
            if list(r.output) != list(clean[rid].output):
                raise AssertionError(f"site={site}: rid={rid} outputs "
                                     "diverged from the fault-free run")
            n += 1
    return n


def check_no_foreign_failure(done: dict, clean: dict, site: str,
                             allowed: tuple[str, ...] = ()) -> None:
    """A FAILED request of the faulted run must be one the fault explains
    (``allowed`` error texts) or have failed in the fault-free run too: a
    real error (a sticky CUDA fault) must not pass as a degradation."""
    for rid, r in done.items():
        if r.state is RequestState.FAILED \
                and clean[rid].state is not RequestState.FAILED \
                and not any(a in (r.error or "") for a in allowed):
            raise AssertionError(f"site={site}: rid={rid} FAILED with an "
                                 f"error the fault does not explain: "
                                 f"{r.error}")


def check_pool_books(engine, site: str) -> int:
    """Every page not leaked is back on the free list; returns the leak."""
    leaked = engine.pool.stats["leaked_pages"]
    if engine.pool.used_pages != leaked:
        raise AssertionError(f"site={site}: pool books off (used="
                             f"{engine.pool.used_pages}, leaked={leaked})")
    return leaked


def check_warnings_name_the_fault(caught, site: str) -> int:
    """Every DegradationWarning of the run names the injected fault."""
    mine = [w for w in caught if issubclass(w.category, DegradationWarning)]
    for w in mine:
        if "injected fault at site" not in str(w.message):
            raise AssertionError(f"site={site}: a degradation not caused by "
                                 f"the injected fault: {w.message}")
    return len(mine)


def _states(done: dict) -> str:
    counts: dict[str, int] = {}
    for r in done.values():
        counts[r.state.value] = counts.get(r.state.value, 0) + 1
    return " ".join(f"{k} {v}" for k, v in sorted(counts.items()))


@contextlib.contextmanager
def _count_graph_captures():
    """Count ``torch.cuda.graph`` contexts opened inside the block."""
    opened = {"n": 0}
    real = torch.cuda.graph

    class counting(real):
        def __enter__(self):
            opened["n"] += 1
            return super().__enter__()

    torch.cuda.graph = counting
    try:
        yield opened
    finally:
        torch.cuda.graph = real


class _FailingReplay:
    def replay(self) -> None:
        raise RuntimeError("replay failed at call time (stub)")


@contextlib.contextmanager
def _failing_replay(exe):
    """Make ``exe``'s next call fail at replay: the recorded CUDA graph on
    the card, the step walk on the CPU."""
    if exe.replay is not None:
        real, exe.replay.graph = exe.replay.graph, _FailingReplay()
        try:
            yield
        finally:
            exe.replay.graph = real
    else:
        real_fn = exe.fn
        exe.fn = lambda *a: _FailingReplay().replay()
        try:
            yield
        finally:
            exe.fn = real_fn


# =============================================================================
# the scenarios
# =============================================================================

def check_fused_route_site(setup: Setup, spec: str, case_name: str) -> str:
    """``kernel_compile`` / ``grouped_gemm_route``: no slower rung in the
    port (ROADMAP C28).  The site raises out of lowering, before a CUDA
    graph opens; nothing is cached; disarmed, the same session takes the
    kernel route and caches it; a call-time replay failure propagates."""
    site = _site(spec)
    case = setup.graph_case(case_name)
    g = case.graph
    sess = Session(setup.session_config(os.path.join(setup.calib_dir, site)))
    plan = FaultPlan.parse(spec)
    t0 = time.perf_counter()
    with activate(plan), _count_graph_captures() as opened:
        try:
            sess.compile(g)
        except FaultInjected as exc:
            if exc.site != site:
                raise AssertionError(f"site={site}: {exc.site} raised") from exc
        else:
            raise AssertionError(f"site={site}: compile did not raise")
    raise_ms = (time.perf_counter() - t0) * 1e3
    if plan.fired[site] != 1:
        raise AssertionError(f"site={site}: fired {plan.fired[site]} times")
    if opened["n"] or (setup.cuda and torch.cuda.is_current_stream_capturing()):
        raise AssertionError(f"site={site}: a CUDA graph was opened")
    stats = sess.cache_stats()
    if stats["exec_entries"] or stats["degraded_routes"] or len(sess.guard_log):
        raise AssertionError(f"site={site}: something cached or degraded "
                             f"({stats})")
    t0 = time.perf_counter()
    model = sess.compile(g)                # disarmed: the kernel route
    got = model(case.inputs)
    setup.sync()
    compile_ms = (time.perf_counter() - t0) * 1e3
    n_fused = int(model.executable.program_stats()[f"n_{case.kernel}"])
    if model.provenance["executable"] != "miss" or n_fused < 1:
        raise AssertionError(f"site={site}: disarmed build {model.provenance} "
                             f"with {n_fused} {case.kernel} steps")
    if sess.cache_stats()["exec_entries"] != 1 or \
            sess.compile(g).provenance["executable"] != "hit":
        raise AssertionError(f"site={site}: the kernel route was not cached")
    want = run_sequential_uncompiled(g, case.inputs,
                                     model.executable.output_ids)
    report = case.agree(got, want, f"site={site} {case.what}")
    replay_ms = setup.timed_ms(lambda: model(case.inputs))
    with _failing_replay(model.executable):
        try:
            model(case.inputs)
        except RuntimeError as exc:
            if "stub" not in str(exc):
                raise
        else:
            raise AssertionError(f"site={site}: a failing replay was rescued")
    if model.explain()["degraded"] or sess.cache_stats()["degraded_routes"]:
        raise AssertionError(f"site={site}: a call-time failure was recorded "
                             "as a degradation")
    return (f"{case.what}: raised FaultInjected({site!r}) while lowering "
            f"after {raise_ms:.1f} ms, no CUDA graph opened, nothing cached; "
            f"disarmed: {n_fused} {case.kernel} steps cached, vs per-op "
            f"{report}; compile {compile_ms:.1f} ms, replay "
            f"{replay_ms:.3f} ms; a failing replay raised")


def _concurrent_disk_writers(dirpath: str) -> str:
    """Eight writers on eight keys (one corrupting mid-write) and eight on
    one key, at once: no temp file stranded, every entry whole."""
    tables = {i: ProfileTable(hw_name="h100", measured_us=((0, 1.0 + i),
                                                           (1, 2.0 * i + 1.0)))
              for i in range(8)}
    corrupting = FaultPlan.single("calib_disk_write", mode="corrupt", times=1)

    def write(i):
        _calib_disk_store(("k", i), tables[i], dirpath=dirpath,
                          faults=corrupting if i == 3 else None)

    def write_shared(i):
        _calib_disk_store(("shared",), tables[i], dirpath=dirpath)

    threads = [threading.Thread(target=fn, args=(i,))
               for fn in (write, write_shared) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stranded = [p for p in os.listdir(dirpath) if p.endswith(".tmp")]
    if stranded:
        raise AssertionError(f"calib_disk_write: temp files stranded {stranded}")
    for i in range(8):
        got = _calib_disk_load(("k", i), dirpath=dirpath)
        if got != (None if i == 3 else tables[i]):
            raise AssertionError(f"calib_disk_write: entry {i} read back {got}")
    if _calib_disk_load(("shared",), dirpath=dirpath) not in tables.values():
        raise AssertionError("calib_disk_write: the raced entry is torn")
    return "16 concurrent writers: no temp file, every entry whole"


def check_graph_site(setup: Setup, spec: str) -> str:
    """A Session site with a slower rung: ``calibration_measure`` (retry,
    then the analytic costs), ``calib_disk_read`` (a miss), ``calib_disk_write``
    (the memory tier only), ``plan_validate`` (the sequential schedule, never
    cached).  The build is held against per-op execution and its
    degradation must be reported."""
    site = _site(spec)
    case = setup.graph_case("branchy")
    g = case.graph
    tier = os.path.join(setup.calib_dir, site)
    if site == "calib_disk_read":       # the read site needs a populated tier
        Session(setup.session_config(tier)).calibrate(g, case.calib)
    cfg = setup.session_config(tier,
                               load_calibration=(site == "calib_disk_read"))
    sess = Session(cfg)
    plan = FaultPlan.parse(spec)
    with activate(plan), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", DegradationWarning)
        t0 = time.perf_counter()
        model = sess.compile(g, inputs=case.calib)
        got = model(case.inputs)
        setup.sync()
        compile_ms = (time.perf_counter() - t0) * 1e3
    if not plan.fired[site]:
        raise AssertionError(f"site={site}: never fired")
    want = run_sequential_uncompiled(g, case.inputs,
                                     model.executable.output_ids)
    report = case.agree(got, want, f"site={site} {case.what}")
    stats = sess.cache_stats()
    reported = (stats["degraded_routes"] + stats["calib_degraded_analytic"]
                + stats["calib_disk_errors"])
    if reported < 1:
        raise AssertionError(f"site={site}: degradation not reported ({stats})")
    events = [e for e in model.explain()["degraded"] if e["site"] == site]
    if not events or any("injected fault" not in e["reason"] for e in events):
        raise AssertionError(f"site={site}: explain()['degraded'] {events}")
    check_warnings_name_the_fault(caught, site)
    extra = ""
    if site == "calibration_measure":
        if model.provenance["calibration"] != "analytic (degraded)" or \
                stats["calib_retries"] != cfg.calib_retries or \
                stats["calib_degraded_analytic"] != 1:
            raise AssertionError(f"site={site}: {model.provenance} {stats}")
        extra = (f"{stats['calib_retries']} retries, then analytic costs "
                 f"({model.provenance['calibration']})")
    elif site == "calib_disk_read":
        if stats["calib_disk_errors"] != 1 or stats["calib_disk_hits"]:
            raise AssertionError(f"site={site}: {stats}")
        reread = Session(cfg).compile(g, inputs=case.calib)
        if reread.provenance["calibration"] != "disk":
            raise AssertionError(f"site={site}: a clean session read back "
                                 f"{reread.provenance}")
        extra = "read error counted, measured again; a clean session hits disk"
    elif site == "calib_disk_write":
        published = [p for p in os.listdir(tier)] if os.path.isdir(tier) else []
        if stats["calib_disk_errors"] != 1 or published:
            raise AssertionError(f"site={site}: {stats}, tier holds "
                                 f"{published}")
        hits = stats["calib_hits"]
        sess.calibrate(g, case.calib)
        if sess.cache_stats()["calib_hits"] != hits + 1:
            raise AssertionError(f"site={site}: the memory tier missed")
        extra = ("nothing published, the memory tier serves; "
                 + _concurrent_disk_writers(os.path.join(tier, "race")))
    elif site == "plan_validate":
        if model.provenance["executable"] != "degraded" or \
                stats["exec_entries"]:
            raise AssertionError(f"site={site}: {model.provenance} {stats}")
        healthy = sess.compile(g, inputs=case.calib)
        if healthy.provenance["executable"] != "miss" or \
                sess.compile(g).provenance["executable"] != "hit":
            raise AssertionError(f"site={site}: the disarmed schedule was "
                                 "not cached")
        extra = "sequential schedule, not cached; disarmed: cached"
    replay_ms = setup.timed_ms(lambda: model(case.inputs))
    clean = setup.clean_build("branchy")
    return (f"{case.what}: {extra}; vs per-op {report}; compile "
            f"{compile_ms:.1f} ms (fault-free {clean['compile_ms']:.1f}), "
            f"replay {replay_ms:.3f} ms (fault-free {clean['replay_ms']:.3f})")


def check_engine_site(setup: Setup, spec: str) -> str:
    """``decode_step`` corrupt: ONE poisoned request FAILED, the co-batch
    completes with fault-free outputs.  Then the raise mode: the watchdog
    latches the eager step, probation re-arms the recorded step, and every
    stream equals the fault-free run's."""
    site = _site(spec)
    _, clean, clean_ms = setup.clean_run("decode_batch")
    plan = FaultPlan.parse(spec)
    engine, done, run_ms = setup.run_trace("decode_batch", plan)
    check_all_terminal(engine, done, site)
    failed = [r for r in done.values() if r.state is RequestState.FAILED]
    if len(failed) != 1 or "non-finite" not in (failed[0].error or ""):
        raise AssertionError(f"site={site}: expected one request FAILED on "
                             f"non-finite logits, got {_states(done)}")
    if check_done_streams(done, clean, site) != 2:
        raise AssertionError(f"site={site}: the co-batch did not complete")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", DegradationWarning)
        watch, wdone, watch_ms = setup.run_trace(
            "decode_batch", FaultPlan.parse("decode_step:raise:1"),
            watchdog_probation=2)
    check_all_terminal(watch, wdone, site)
    if check_done_streams(wdone, clean, site) != len(clean):
        raise AssertionError(f"site={site}: the watchdog run lost a stream "
                             f"({_states(wdone)})")
    stats = watch.fault_stats
    if stats["watchdog_fallbacks"] != 1 or stats["watchdog_probations"] != 1 \
            or not watch._use_compiled:
        raise AssertionError(f"site={site}: watchdog rungs {stats}")
    if check_warnings_name_the_fault(caught, site) != 1:
        raise AssertionError(f"site={site}: expected one watchdog warning")
    graph_ms = setup.timed_ms(lambda: watch._step([watch.last_token,
                                                   watch.pos]))
    eager_ms = setup.timed_ms(watch._eager_decode)
    return (f"1 FAILED (non-finite), 2 DONE equal to fault-free; raise:1 "
            f"latched eager, probation re-armed the "
            f"{'recorded graph' if watch.decode_graph is not None else 'step'}"
            f", {len(wdone)} streams equal; run {run_ms:.0f} ms (fault-free "
            f"{clean_ms:.0f}); tick: eager watchdog {eager_ms:.3f} ms vs "
            f"{'graph' if setup.cuda else 'compiled (eager on the CPU)'} "
            f"{graph_ms:.3f} ms")


def check_overload_site(setup: Setup, spec: str) -> str:
    """Serving overload with an admission-tier fault armed: no crash, no
    stranded request, the fault counted, DONE streams equal to the
    fault-free run's."""
    site = _site(spec)
    _, clean, clean_ms = setup.clean_run("overload")
    engine, done, run_ms = setup.run_trace("overload", FaultPlan.parse(spec))
    check_all_terminal(engine, done, site)
    counter = SITE_COUNTER[site]
    if engine.fault_stats[counter] < 1:
        raise AssertionError(f"site={site}: fault not counted "
                             f"({engine.fault_stats})")
    check_no_foreign_failure(done, clean, site)
    if site == "admission_enqueue":
        shed = [r for r in done.values() if "injected fault" in (r.error or "")]
        if len(shed) != engine.fault_stats[counter] or \
                any(r.state is not RequestState.SHED for r in shed):
            raise AssertionError(f"site={site}: {len(shed)} requests carry "
                                 "the fault's provenance")
    n = check_done_streams(done, clean, site)
    return (f"{counter} {engine.fault_stats[counter]}, states {_states(done)} "
            f"(fault-free {_states(clean)}), {n} DONE streams equal; run "
            f"{run_ms:.0f} ms over {engine.tick} ticks (fault-free "
            f"{clean_ms:.0f} ms)")


def check_preempt_site(setup: Setup, spec: str) -> str:
    """``slot_preempt`` raise: the preemption is skipped (the victim keeps
    its slot, the critical request expires instead), never a crash."""
    site = _site(spec)
    _, clean, clean_ms = setup.clean_run("preempt")
    if clean[1].state is not RequestState.DONE or clean[0].preemptions != 1:
        raise AssertionError("slot_preempt: the fault-free run did not "
                             "preempt")
    engine, done, run_ms = setup.run_trace("preempt", FaultPlan.parse(spec))
    check_all_terminal(engine, done, site)
    if engine.fault_stats["preempt_faults"] < 1:
        raise AssertionError(f"preemption fault not counted "
                             f"({engine.fault_stats})")
    batch, prod = done[0], done[1]
    if batch.state is not RequestState.DONE or \
            list(batch.output) != list(clean[0].output):
        raise AssertionError(f"site={site}: the victim's stream changed")
    if prod.state is not RequestState.EXPIRED:
        raise AssertionError(f"site={site}: the critical request ended "
                             f"{prod.state}")
    return (f"preempt_faults {engine.fault_stats['preempt_faults']}, victim "
            f"DONE equal to its fault-free (preempted, re-prefilled) stream, "
            f"critical request EXPIRED; run {run_ms:.0f} ms (fault-free "
            f"{clean_ms:.0f})")


def check_paged_site(setup: Setup, spec: str) -> str:
    """Paged-KV overload with a page-tier fault armed: no crash, no stranded
    request, the fault counted, DONE streams equal to the fault-free run's,
    and the pool's books balance (every page not leaked is free)."""
    site = _site(spec)
    _, clean, clean_ms = setup.clean_run("paged")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", DegradationWarning)
        engine, done, run_ms = setup.run_trace("paged", FaultPlan.parse(spec))
    check_all_terminal(engine, done, site)
    counter = SITE_COUNTER[site]
    if engine.fault_stats[counter] < 1:
        raise AssertionError(f"site={site}: fault not counted "
                             f"({engine.fault_stats})")
    check_no_foreign_failure(done, clean, site)
    check_warnings_name_the_fault(caught, site)
    n = check_done_streams(done, clean, site)
    leaked = check_pool_books(engine, site)
    extra = ""
    if site == "page_release":
        if leaked < 1:
            raise AssertionError(f"site={site}: failed release did not leak")
        if engine.health()["paged"]["leaked_pages"] != leaked:
            raise AssertionError(f"site={site}: health() hides the leak")
        extra = f", {leaked} pages leaked and reported by health()"
    if site == "block_table_build":
        if engine.fault_stats["paged_decode_fallbacks"] < 1:
            raise AssertionError(f"site={site}: dense-gather rung not taken")
        paged_ms = setup.timed_ms(engine._paged_step)
        gather_ms = setup.timed_ms(engine._dense_gather_decode)
        extra = (f", dense-gather rung {engine.fault_stats['paged_decode_fallbacks']}"
                 f"x; tick: dense-gather {gather_ms:.3f} ms vs paged "
                 f"{paged_ms:.3f} ms")
    return (f"{counter} {engine.fault_stats[counter]}, states {_states(done)} "
            f"(fault-free {_states(clean)}), {n} DONE streams equal, pool "
            f"books balance{extra}; run {run_ms:.0f} ms over {engine.tick} "
            f"ticks (fault-free {clean_ms:.0f} ms)")


def _fused(case_name: str):
    return lambda setup, spec: check_fused_route_site(setup, spec, case_name)


# (spec, check, kernels a full-size run must launch), in the JAX script's
# order
SCENARIOS: list[tuple[str, Callable[[Setup, str], str], tuple[str, ...]]] = [
    ("kernel_compile:raise:-1", _fused("branchy"), ("branch_gemm",)),
    ("grouped_gemm_route:raise:-1", _fused("ragged"), ("grouped_gemm",)),
    ("kernel_compile:raise:-1", _fused("arch"), ("branch_gemm",)),
    ("calibration_measure:raise:-1", check_graph_site, ()),
    ("calib_disk_read:raise:-1", check_graph_site, ()),
    ("calib_disk_write:raise:-1", check_graph_site, ()),
    ("plan_validate:raise:-1", check_graph_site, ()),
    ("decode_step:corrupt:1:0", check_engine_site,
     ("rmsnorm", "flash_attention", "decode_attention")),
    # serving tier under overload: burst trace x each admission fault site
    ("admission_enqueue:raise:2", check_overload_site,
     ("rmsnorm", "flash_attention", "decode_attention")),
    ("deadline_check:raise:-1", check_overload_site,
     ("rmsnorm", "flash_attention", "decode_attention")),
    ("slot_preempt:raise:-1", check_preempt_site,
     ("rmsnorm", "flash_attention", "decode_attention")),
    # paged-KV tier: burst trace x each page fault site
    ("page_alloc:raise:2", check_paged_site,
     ("rmsnorm", "flash_attention", "paged_decode")),
    ("block_table_build:raise:1", check_paged_site,
     ("rmsnorm", "flash_attention", "paged_decode", "decode_attention")),
    ("page_release:raise:1", check_paged_site,
     ("rmsnorm", "flash_attention", "paged_decode")),
]

# scenarios that drive the serving engine (skipped by --skip-engine)
ENGINE_SITES = ("decode_step", "admission_enqueue", "deadline_check",
                "slot_preempt", "page_alloc", "block_table_build",
                "page_release")


def _kernel_ops() -> dict:
    from repro_torch.kernels.branch_gemm import ops as bops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.grouped_gemm import ops as gops
    from repro_torch.kernels.paged_decode import ops as pops
    from repro_torch.kernels.rmsnorm import ops as rops
    return {"branch_gemm": bops, "grouped_gemm": gops, "rmsnorm": rops,
            "flash_attention": fops, "decode_attention": dops,
            "paged_decode": pops}


def launch_counts() -> dict:
    """Each kernel's wrapper launches, by route."""
    return {name: dict(ops.launches_by_route)
            for name, ops in _kernel_ops().items()}


def launches_since(before: dict) -> dict:
    """Launches by kernel and route since ``before`` (zeros left out)."""
    out = {}
    for name, routes in launch_counts().items():
        d = {r: n - before[name].get(r, 0) for r, n in routes.items()
             if n - before[name].get(r, 0)}
        if d:
            out[name] = d
    return out


def check_launches(spec: str, launched: dict, want: tuple[str, ...]) -> None:
    """A full-size scenario launched each of its kernels, none off its
    kernel route (``simple`` is the routine for odd shapes)."""
    missing = [k for k in want if not launched.get(k)]
    if missing:
        raise AssertionError(f"{spec}: no launch of {missing} ({launched})")
    off = {k: r for k, r in launched.items() if "simple" in r}
    if off:
        raise AssertionError(f"{spec}: launches on the simple route {off}")


def run_all(setup: Setup, say: Callable[[str], None] = print,
            skip_engine: bool = False) -> int:
    """Run every scenario; one ``[chaos]`` line each and a summary line.
    Returns the number of sites that broke the contract."""
    failures = skipped = 0
    for spec, check, kernels in SCENARIOS:
        if skip_engine and spec.startswith(ENGINE_SITES):
            say(f"[chaos] SKIP {spec}")
            skipped += 1
            continue
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DegradationWarning)
                report = check(setup, spec)
            setup.sync()               # a sticky CUDA error surfaces here
            launched = launches_since(before)
            if setup.cuda and setup.size == "full":
                check_launches(spec, launched, kernels)
            say(f"[chaos] {spec} ok ({time.perf_counter() - t0:.1f} s): "
                f"{report}; launches {launched or 'none (plain versions)'}")
        except Exception:
            failures += 1
            say(f"[chaos] FAIL {spec}")
            say(traceback.format_exc().rstrip())
    n = len(SCENARIOS)
    say(f"[chaos] {n - skipped - failures}/{n} sites clean"
        + (f" ({skipped} skipped)" if skipped else ""))
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--size", choices=("smoke", "full"), default=None,
                    help="default: full on cuda, smoke on the CPU")
    ap.add_argument("--skip-engine", action="store_true",
                    help="skip the serving-engine scenarios")
    args = ap.parse_args(argv)
    size = args.size or ("full" if args.device == "cuda" else "smoke")
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    setup = Setup(args.device, size)
    try:
        failures = run_all(setup, skip_engine=args.skip_engine)
    finally:
        setup.close()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
