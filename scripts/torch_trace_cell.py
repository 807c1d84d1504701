"""Run one cell of the port's benchmark with the program's own spans on.

    python3 scripts/torch_trace_cell.py --workload glm4-9b.b1s512 \\
        --seed 7 --seconds 45

from the root of a checkout, on a CUDA card.  The run is the benchmark's
``--trace 1`` run (``portbench.harness.run_cell``: set-up, the untraced
window, a short window under ``torch.profiler``, the check against the
reference) with ``repro_torch.trace`` turned on before the set-up.  The
records are split where the harness's window starts (once the set-up's
lines are printed) and ends (when the profiled window starts), and the
script prints:

- ``[program] spans <phase>``: per span name, calls, total, self and
  device ms, for the set-up, the window and the profiled window;
- ``[program] window by 5 s``: the mean ``replay.device`` and
  ``replay.submit`` ms per 5 s from the window's start;
- ``[program] metrics``: ``replay_ms`` (mean ``replay.device`` of the
  window), ``submit_ms`` (mean ``replay.submit``), ``forward_ms`` (the
  window's wall time over its forwards, as the harness reads it),
  ``outside_replay_ms`` (the two's difference), the profiled window's
  ``traced_replay_ms``, ``record_ms`` (the ``record`` span) and
  ``export_ms`` (the ``export`` span);
- ``[program] counters``: per counter of the program (read by the window's
  ``replay.device`` spans once their events completed), over the window's
  forwards: the expert-parallel MoE layer's ``moe.held_counts``, the routed
  pairs a forward sends to the held experts (mean, least, most; beside
  their expected number, tokens · top-k · held / experts a layer) and the
  largest count of one expert in one layer against the static capacity;
- ``[program] expert_roofline``: for a configuration with held experts,
  the least time of their MLP (``portbench/families/moe.py``, from each
  profiled forward's counts: the weights of each held expert with a row
  once, the rows in and out, or the rows' operations), over the device
  time of moe_gemm's kernels per forward in the profiled window (%);

then the harness's result line, as ``portbench/run.py`` prints it.  It
imports neither JAX nor the JAX package.  It stands in for the harness's
own reading of the spans, which only a change to the benchmark may add;
that change removes this script.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

T_START = time.perf_counter()
REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]

from portbench import harness  # noqa: E402
from repro_torch import trace  # noqa: E402

STEP_NS = 5_000_000_000


def span_table(spans) -> dict[str, list]:
    """name -> [calls, total ms, self ms, device ms or None]."""
    return {name: [c["calls"], round(c["host_ns"] / 1e6, 4),
                   round(c["self_ns"] / 1e6, 4),
                   None if c["device_ns"] is None
                   else round(c["device_ns"] / 1e6, 4)]
            for name, c in trace.summary(spans).items()}


def mean_ms(spans, name: str, device: bool = False) -> float | None:
    vals = [(s.device_ns if device else s.ns) for s in spans
            if s.name == name]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) / 1e6 if vals else None


def by_step(spans, start_ns: int) -> dict[str, list]:
    """Mean ``replay.device`` and ``replay.submit`` ms per 5 s from
    ``start_ns``."""
    out: dict[str, list] = {}
    for name, device in (("replay.device", True), ("replay.submit", False)):
        bins: dict[int, list] = {}
        for s in spans:
            v = s.device_ns if device else s.ns
            if s.name == name and v is not None:
                bins.setdefault((s.start_ns - start_ns) // STEP_NS,
                                []).append(v)
        out[name] = [round(sum(v) / len(v) / 1e6, 4)
                     for _, v in sorted(bins.items())]
    return out


def _flat(values) -> list:
    return [x for v in values for x in _flat(v)] if isinstance(
        values, list) else [values]


def counter_report(spans, meta: dict[str, dict]) -> dict[str, dict]:
    """Each counter over the spans that read it: the sum of its values per
    forward (mean, least, most) and its largest value, beside its
    ``meta``; for ``moe.held_counts`` also the expected sum, capacity ·
    top-k · held / experts a MoE layer."""
    out: dict[str, dict] = {}
    for name, info in meta.items():
        reads = [s.counters[name] for s in spans
                 if s.counters and name in s.counters]
        if not reads:
            continue
        sums = [sum(_flat(r)) for r in reads]
        out[name] = {"forwards": len(reads),
                     "sum_mean": sum(sums) / len(sums),
                     "sum_min": min(sums), "sum_max": max(sums),
                     "largest": max(max(_flat(r)) for r in reads), **info}
        if name == "moe.held_counts":
            held = info["experts"][1]
            out[name]["sum_expected"] = (len(reads[0]) * info["capacity"]
                                         * info["top_k"] * held
                                         / info["n_experts"])
    return out


def expert_roofline(cell: "harness.Cell", result: dict,
                    spans) -> dict | None:
    """The held experts' MLP against its roofline over the profiled
    forwards: the mean least time from their counts over moe_gemm's device
    time per forward."""
    from portbench.metrics import expert_ms
    family = harness.family_module(cell.cfg)
    reads = [s.counters["moe.held_counts"] for s in spans
             if s.counters and "moe.held_counts" in s.counters]
    if not (reads and hasattr(family, "expert_mlp_least_seconds")
            and result.get("breakdown")):
        return None
    peaks = harness.read_json(harness.HERE / "yardstick" / "peaks.json")
    least = sum(family.expert_mlp_least_seconds(cell.cfg, r, peaks)
                for r in reads) / len(reads)
    busy = expert_ms.device_seconds(result["breakdown"]["device_ops"])
    return {"value": 100.0 * least / busy if busy > 0 else None,
            "least_ms": 1e3 * least, "kernel_ms": 1e3 * busy,
            "forwards": len(reads)}


def trace_cell(cell: "harness.Cell", seed: int, seconds: float,
               device: str = "cuda") -> tuple[dict, dict]:
    """One ``--trace 1`` run of ``cell`` with the program's tracing on:
    (the harness's result, the program's report: ``spans`` per phase,
    ``by_step`` and ``metrics``)."""
    marks: dict[str, int] = {}
    describe = harness.describe_program
    summarize = harness.summarize_trace
    traced_window = harness.traced_window

    def describe_then_mark(model) -> None:
        describe(model)
        marks["window"] = time.perf_counter_ns()

    def mark_traced(call, n, sync):
        marks["window_end"] = time.perf_counter_ns()
        return traced_window(call, n, sync)

    def summarize_kernels(events, n, window_s):
        # kineto also puts each span on the device timeline (a
        # gpu_user_annotation over the kernels launched inside it): those
        # are no kernels, and the harness's summary takes every event on
        # the device for one
        names = set(trace.summary())
        return summarize([e for e in events if not (e[1] and e[0] in names)],
                         n, window_s)

    harness.describe_program = describe_then_mark
    harness.traced_window = mark_traced
    harness.summarize_trace = summarize_kernels
    trace.reset()
    trace.enable()
    try:
        result = harness.run_cell(cell, seed, seconds, True, device=device,
                                  t_start=T_START)
    finally:
        trace.enable(False)
        harness.describe_program = describe
        harness.traced_window = traced_window
        harness.summarize_trace = summarize
    spans = trace.records()
    meta = trace.counter_meta()
    trace.reset()
    w0, w1 = marks["window"], marks["window_end"]
    phases = {"setup": [s for s in spans if s.end_ns <= w0],
              "window": [s for s in spans if w0 <= s.start_ns < w1],
              "traced": [s for s in spans if s.start_ns >= w1]}
    window = phases["window"]
    n = sum(s.name == "forward" for s in window)
    forward_ms = (w1 - w0) / n / 1e6
    replay_ms = mean_ms(window, "replay.device", device=True)
    metrics = {
        "forwards": n, "forward_ms": forward_ms,
        "replay_ms": replay_ms,
        "outside_replay_ms": (None if replay_ms is None
                              else forward_ms - replay_ms),
        "submit_ms": mean_ms(window, "replay.submit"),
        "copy_in_ms": mean_ms(window, "replay.copy_in"),
        "copy_out_ms": mean_ms(window, "replay.copy_out"),
        "traced_replay_ms": mean_ms(phases["traced"], "replay.device",
                                    device=True),
        "record_ms": mean_ms(spans, "record"),
        "export_ms": mean_ms(spans, "export"),
        "compile_ms": mean_ms(spans, "compile"),
    }
    report = {"spans": {k: span_table(v) for k, v in phases.items()},
              "by_step": by_step(window, w0), "metrics": metrics,
              "counters": counter_report(window, meta),
              "expert_roofline": expert_roofline(cell, result,
                                                 phases["traced"])}
    return result, report


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    # the caches and the environment of portbench/run.py
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(REPO / "build" / "portbench" / sub)
    os.environ.pop("REPRO_TORCH_FAULT_PLAN", None)
    result, report = trace_cell(harness.load_cell(args.workload),
                                args.seed & (2 ** 63 - 1), args.seconds)
    for phase, table in report["spans"].items():
        print(f"[program] spans {phase} " + json.dumps(table))
    print("[program] window by 5 s " + json.dumps(report["by_step"]))
    print("[program] metrics " + json.dumps(report["metrics"]))
    print("[program] counters " + json.dumps(report["counters"]))
    print("[program] expert_roofline "
          + json.dumps(report["expert_roofline"]))
    found = harness.forbidden_modules()
    if found:
        print(f"modules loaded that may not be: {found}", file=sys.stderr)
        return 3
    print(f"correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
