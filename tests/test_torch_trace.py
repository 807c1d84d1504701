"""The port's own spans and counters (``repro_torch.trace``) on the CPU.

Off (the default) a call records nothing and a span site hands back one
shared empty context; on, the spans nest (parent ids, one forward id per
call, self time = duration less the children's), the outputs stay
bit-equal, ``Session.compile``'s ``timings_ms`` read the ``compile``
spans, the exporter is one span, a device span's time is read only
from completed events (never by waiting), and under ``torch.profiler``
the spans are kineto events that enclose the aten ops they issue.  The
card's half (the replay spans, no synchronize added) is in
``tests/test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Session, SessionConfig  # noqa: E402
from repro_torch.core.graph import OpGraph, OpKind  # noqa: E402
from repro_torch.core.profiler import (  # noqa: E402
    H100_SXM, elementwise_cost, gemm_cost)
from repro_torch.core.scheduler import compile_plan, schedule  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models.opgraph_export import build_lm_opgraph  # noqa: E402
from repro_torch.models.transformer import init_lm  # noqa: E402


@pytest.fixture(autouse=True)
def clean_trace():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _mm(x, w):
    return x @ w


def _sum(*xs):
    return sum(xs)


def _branchy(width=3, d=16, tokens=8, seed=0):
    """Parallel (gemm → relu) branches, then a sum, twice."""
    rng = np.random.default_rng(seed)
    g = OpGraph("branchy")
    cur = g.add("x", OpKind.INPUT, out_shape=(tokens, d),
                out_dtype=torch.float32)
    for blk in range(2):
        outs = []
        for b in range(width):
            w = torch.tensor(rng.standard_normal((d, d)) * 0.1,
                             dtype=torch.float32)
            c = g.add(f"b{blk}_{b}_gemm", OpKind.GEMM, [cur], fn=_mm,
                      cost=gemm_cost(tokens, d, d, 4),
                      fuse_sig=("gemm", tokens, d, d), consts=(w,),
                      payload="matmul")
            outs.append(g.add(f"b{blk}_{b}_relu", OpKind.ELEMENTWISE, [c],
                              fn=torch.relu,
                              cost=elementwise_cost(tokens * d, 4),
                              fuse_sig=("relu", tokens, d)))
        cur = g.add(f"b{blk}_sum", OpKind.ELEMENTWISE, outs, fn=_sum,
                    cost=elementwise_cost(tokens * d, 4, n_in=width))
    return g


def _request(seed=1, d=16, tokens=8):
    rng = np.random.default_rng(seed)
    return {"x": torch.tensor(rng.standard_normal((tokens, d)),
                              dtype=torch.float32)}


def _session(tmp_path):
    return Session(SessionConfig(device="cpu", hw=H100_SXM,
                                 calib_dir=str(tmp_path / "calib")))


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_tracing_off_records_nothing_and_allocates_no_span():
    exe = compile_plan(schedule(_branchy(), "opara", "opara"))
    exe(_request())
    assert trace.records() == [] and trace.summary() == {}
    # off, a site's span is the one shared empty context
    assert trace.span("replay.copy_in") is trace.span("walk")
    with trace.span("anything") as s:
        assert s is None
    assert trace.records() == []


def test_outputs_are_bit_equal_with_tracing_on_and_off():
    exe = compile_plan(schedule(_branchy(), "opara", "opara"))
    req = _request()
    off = exe(req)
    trace.enable()
    on = exe(req)
    trace.enable(False)
    assert len(on) == len(off)
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    assert trace.summary()["forward"]["calls"] == 1


def test_spans_nest_with_parents_forwards_and_self_time(tmp_path):
    graph = _branchy()
    trace.enable()
    model = _session(tmp_path).compile(graph, inputs={0: _request()["x"]})
    for seed in (1, 2):
        model(_request(seed))
    spans = trace.records()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    (comp,) = by_name["compile"]
    assert comp.parent is None and comp.forward is None
    assert [s.name for s in _children(spans, comp)] == [
        "compile.calibrate", "compile.plan", "compile.capture"]
    forwards = by_name["forward"]
    assert len(forwards) == 2 and len({f.forward for f in forwards}) == 2
    for f in forwards:
        assert f.forward == f.id and f.parent is None
        (walk,) = _children(spans, f)
        assert walk.name == "walk" and walk.forward == f.id
        assert f.start_ns <= walk.start_ns <= walk.end_ns <= f.end_ns
    for s in spans:
        kids = _children(spans, s)
        assert s.self_ns == s.ns - sum(k.ns for k in kids)
        assert s.self_ns >= 0
    summary = trace.summary()
    assert summary["forward"]["calls"] == 2
    assert summary["forward"]["host_ns"] == sum(f.ns for f in forwards)
    assert summary["forward"]["self_ns"] == sum(f.self_ns for f in forwards)
    assert summary["forward"]["device_ns"] is None


def test_a_forward_span_starts_a_forward_that_its_children_carry():
    trace.enable()
    with trace.span("outer") as outer:
        with trace.span("fwd", forward=True) as fwd:
            with trace.span("inner") as inner:
                pass
        with trace.span("after"):
            pass
    spans = {s.name: s for s in trace.records()}
    assert spans["outer"].forward is None
    assert spans["fwd"].forward == spans["fwd"].id
    assert spans["inner"].forward == spans["fwd"].id
    assert spans["inner"].parent == spans["fwd"].id
    assert spans["fwd"].parent == spans["outer"].id
    assert spans["after"].forward is None
    assert spans["outer"].child_ns == spans["fwd"].ns + spans["after"].ns
    assert (outer.ns, fwd.ns, inner.ns) == (
        spans["outer"].ns, spans["fwd"].ns, spans["inner"].ns)
    trace.reset()
    assert trace.records() == []


def test_timings_ms_are_a_view_of_the_compile_spans(tmp_path):
    graph = _branchy()
    sess = _session(tmp_path)
    # off: the same four keys, and nothing recorded
    model = sess.compile(graph, inputs={0: _request()["x"]})
    assert set(model.timings_ms) == {"calibrate", "plan", "compile", "total"}
    assert all(v >= 0 for v in model.timings_ms.values())
    assert model.timings_ms["total"] >= (model.timings_ms["calibrate"]
                                         + model.timings_ms["plan"]
                                         + model.timings_ms["compile"])
    assert trace.records() == []
    # on: each value equals its span's
    trace.enable()
    model = _session(tmp_path).compile(_branchy(),
                                       inputs={0: _request()["x"]})
    spans = {s.name: s for s in trace.records()}
    for key, name in (("calibrate", "compile.calibrate"),
                      ("plan", "compile.plan"),
                      ("compile", "compile.capture"), ("total", "compile")):
        assert model.timings_ms[key] == spans[name].ns / 1e6
    # no profiling inputs: no calibration span, calibrate reads 0
    trace.reset()
    model = _session(tmp_path).compile(_branchy())
    assert model.timings_ms["calibrate"] == 0.0
    assert "compile.calibrate" not in trace.summary()
    assert model.timings_ms["total"] == trace.summary()["compile"][
        "host_ns"] / 1e6


@pytest.mark.parametrize("arch", ["glm4-9b", "hymba-1.5b", "rwkv6-1.6b",
                                  "kimi-k2-1t-a32b"])
def test_the_exporter_names_its_stages(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    off = build_lm_opgraph(cfg, 1, 8, params)
    assert trace.records() == []
    trace.enable()
    g = build_lm_opgraph(cfg, 1, 8, params)
    (export,) = trace.records()
    assert export.name == "export" and export.parent is None
    assert export.child_ns == 0 and export.ns > 0
    # the graph is the same with tracing on
    assert g.signature_digest() == off.signature_digest()


def test_spans_are_kineto_events_that_enclose_their_aten_ops():
    from torch.profiler import ProfilerActivity, profile

    exe = compile_plan(schedule(_branchy(), "opara", "opara"))
    trace.enable()
    exe(_request())
    trace.reset()
    req = _request(2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exe(req)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    walks = [e for e in events if e[0] == "walk"]
    forwards = [e for e in events if e[0] == "forward"]
    assert len(walks) == 1 and len(forwards) == 1
    (_, w0, w1), (_, f0, f1) = walks[0], forwards[0]
    assert f0 <= w0 <= w1 <= f1
    aten = [e for e in events if e[0].startswith("aten::")]
    assert {"aten::relu", "aten::add"} <= {e[0] for e in aten}
    assert all(w0 <= a <= b <= w1 for _, a, b in aten)
    # and the program's own records hold the same spans
    assert {s.name for s in trace.records()} == {"forward", "walk"}


class _FakeEvent:
    """A timing event whose completion the test decides; waiting on it
    fails the test."""

    done = False

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.recorded = False

    def record(self, stream=None):
        self.recorded = True

    def query(self):
        return _FakeEvent.done

    def elapsed_time(self, end):
        assert self.recorded and end.recorded and _FakeEvent.done
        return 2.5

    def synchronize(self):
        raise AssertionError("a device span waited on the card")


def test_device_time_is_read_only_from_completed_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "done", False)
    trace.enable()
    with trace.span("forward", forward=True):
        with trace.span("replay.device", device=True):
            pass
    (dev,) = [s for s in trace.records() if s.name == "replay.device"]
    assert dev.device_ns is None
    assert trace.summary()["replay.device"]["device_calls"] == 0
    _FakeEvent.done = True
    # the next forward reads what has completed
    with trace.span("forward", forward=True):
        pass
    assert dev.device_ns == 2_500_000
    assert trace.summary()["replay.device"] == {
        "calls": 1, "host_ns": dev.ns, "self_ns": dev.ns,
        "device_ns": 2_500_000, "device_calls": 1}


def test_the_kernel_build_is_a_span(monkeypatch, tmp_path):
    """``kernels.build`` times the parallel nvcc run (here a stand-in
    compiler that does nothing) where ``build_seconds`` used to."""
    assert not hasattr(_build, "build_seconds")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "true")
    monkeypatch.setattr(_build, "build_log", {})
    trace.enable()
    outs = _build.build()
    assert all(p.parent == tmp_path and p.exists() for p in outs)
    assert set(_build.build_log) == {p.name for p in _build.sources()}
    assert trace.summary()["kernels.build"]["calls"] == 1
    _build.build()                      # every library there: no build
    assert trace.summary()["kernels.build"]["calls"] == 1


def test_the_trace_cell_script_splits_a_cpu_run_into_its_phases(
        monkeypatch, tmp_path):
    """``scripts/torch_trace_cell.py`` on a smoke-sized dense cell on the
    CPU: the set-up holds the export and compile spans, the window its
    forwards, the profiled window its own, and the run stays correct; on
    the CPU there is no replay, so ``replay_ms`` reads None."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "torch_trace_cell", root / "scripts" / "torch_trace_cell.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    harness = script.harness
    monkeypatch.setattr(harness, "BUILD", tmp_path / "build")
    cfg = {"name": "glm4-9b-smoke", "source": "smoke", "family": "dense",
           "dtype": "bfloat16", "n_layers": 2, "d_model": 64, "n_heads": 4,
           "n_kv_heads": 2, "d_head": 16, "d_ff": 160, "vocab_size": 256,
           "qkv_bias": True, "tie_embeddings": False, "norm": "rmsnorm",
           "norm_eps": 1e-6, "window": None, "global_layers": [],
           "meta_tokens": 0, "ssm": None, "reduced": []}
    # the sample is the window's first forward, which every window runs,
    # however slowly a loaded machine runs it
    traffic = {"loop": "closed", "clients": 1, "batch": 1, "seq": 16,
               "pool": 8, "sample": 1, "sample_from": 1, "warmup": 1,
               "trace_seconds": 0.05, "warmup_seconds": 0.05}
    m = harness.manifest()
    cell = harness.Cell("smoke", cfg, traffic, {"row_rel_l2": 0.2,
                                                 "pos_rel_l2": 0.25},
                        m["end_to_end"], m["per_layer"])
    result, report = script.trace_cell(cell, 2 ** 31 + 5, 0.3, "cpu")
    assert result["correct"] is True, result["checks"]
    setup, window = report["spans"]["setup"], report["spans"]["window"]
    assert {"export", "compile", "forward", "walk"} <= set(setup)
    assert set(window) == {"forward", "walk"}
    metrics = report["metrics"]
    assert window["forward"][0] == metrics["forwards"] == result["attempted"]
    assert metrics["export_ms"] > 0 and metrics["compile_ms"] > 0
    assert metrics["replay_ms"] is None and metrics["record_ms"] is None
    traced = report["spans"]["traced"]
    assert set(traced) == {"forward", "walk"}
    assert traced["forward"][0] == traced["walk"][0] >= 3
    assert not trace.on and trace.records() == []
