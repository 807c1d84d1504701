"""The benchmark of the PyTorch/CUDA port's op-graph inference path.

One run of one cell: make the weights and a pool of prompts from the
seed, build the op graph (``build_lm_opgraph``), compile it with the
autotuning ``Session`` (the README's main path), warm it up, then call the
``CompiledModel`` closed loop, one client, for the window; read the peak
memory, optionally trace a short window of back-to-back forwards, free the
program and hold a seeded sample of the window's logits against the plain
float32 reference.

Everything is found by name: a cell is ``workloads/<cell>.json`` naming a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); a configuration's ``family`` names its
layout and counts (``families/<family>.py``) and its reference
(``reference/<family>.py``); a per-layer metric is
``metrics/<metric>.py``.  ``BENCHMARK.json`` at the root of the checkout
says which metrics a cell reports.

A configuration file's keys are the fields of the port's ``ModelConfig``
(nested groups such as ``moe``, ``mla`` and ``ssm`` as objects of their
own fields, ``dtype`` by name), the benchmark's own keys, ``OWN_KEYS``,
and the keys of the source's published configuration that the file lists
under ``published`` (kept as published, read by no program); a field the
file leaves out keeps ``ModelConfig``'s default, and any other key is
refused.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import pathlib
import random
import re
import statistics
import sys
import time
import typing
from typing import Any, Callable

import torch

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
# fixed directories inside the checkout: the calibration tier of the
# program's Session; the kernels build under build/kernels (the program's)
BUILD = REPO / "build" / "portbench"
# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the keys of a configuration file that are the benchmark's and not the
# port's; "published" lists the file's keys that are the source's own
# configuration, which may name no field of the port's ModelConfig
OWN_KEYS = ("norm_eps", "reduced", "deployment", "assumed", "not_on_path",
            "published")
# the scale of each kind of leaf of the benchmark's weights: N(0, 1) times
# the scale (linear weights by their fan-in), plus 1 for norm scales and
# the Mamba skip; a_log is Mamba's own A = 1..state_dim
INIT_SCALES = {"embed": 0.02, "bias": 0.1, "conv": 0.2, "norm": 0.1,
               "d_skip": 0.1}
GIB = 2 ** 30


def read_json(path: pathlib.Path) -> Any:
    return json.loads(path.read_text())


def say(*parts: Any) -> None:
    print(*parts, flush=True)


@dataclasses.dataclass
class Cell:
    """One cell: a configuration under a traffic mix, with the limits of
    its correctness check and the metrics it reports."""

    name: str
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list = dataclasses.field(default_factory=list)
    per_layer: list = dataclasses.field(default_factory=list)


def manifest(root: pathlib.Path = HERE) -> dict | None:
    path = root.parent / "BENCHMARK.json"
    return read_json(path) if path.exists() else None


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = HERE) -> Cell:
    """The cell ``name`` from the files under ``root``; raises KeyError
    where a file is missing or disagrees with ``BENCHMARK.json``."""
    path = root / "workloads" / f"{name}.json"
    if not path.exists():
        raise KeyError(f"no cell {name!r} ({path} is missing)")
    spec = read_json(path)
    cfg = read_json(root / "configs" / f"{spec['config']}.json")
    traffic = read_json(root / "traffic" / f"{spec['traffic']}.json")
    if (traffic["loop"], traffic["clients"]) != ("closed", 1):
        raise ValueError(f"{spec['traffic']}: the harness drives one "
                         "closed-loop client")
    cell = Cell(name, cfg, traffic, spec["limits"])
    m = manifest(root)
    if m is not None:
        entry = next((w for w in m["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"BENCHMARK.json has no cell {name!r}")
        if (entry["config"], entry["traffic"]) != (spec["config"],
                                                   spec["traffic"]):
            raise KeyError(f"{path.name} and BENCHMARK.json disagree on "
                           f"{name!r}")
        cell.end_to_end = [x for x in m["end_to_end"] if _reports(x, name)]
        cell.per_layer = [x for x in m["per_layer"] if _reports(x, name)]
    return cell


def family_module(cfg: dict):
    return importlib.import_module(f"portbench.families.{cfg['family']}")


def reference_module(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['family']}")


def metric_reader(name: str) -> Callable[[dict], float | None]:
    return importlib.import_module(f"portbench.metrics.{name}").read


# -- inputs --------------------------------------------------------------------

def make_weights(cfg: dict, seed: int, device: str) -> dict:
    """The configuration's weights in the port's parameter layout, drawn on
    ``device`` from ``seed``: every normal leaf of one dtype is a view of
    one buffer filled by one ``randn`` call, then scaled in place.  A
    family's leaf is ``(path, shape, kind)``, in the configuration's dtype
    (the Mamba A and skip in float32, as the port keeps them), or ``(path,
    shape, kind, dtype)`` with the dtype by name."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = DTYPES[cfg["dtype"]]
    leaves = []
    for path, shape, kind, *named in family_module(cfg).leaves(cfg):
        if named:
            dt = DTYPES[named[0]]
        else:  # the port keeps the Mamba A and skip in float32
            dt = torch.float32 if kind in ("a_log", "d_skip") else dtype
        leaves.append((path, shape, kind, dt))
    offsets, totals = [], {}
    for _, shape, _, dt in leaves:
        offsets.append(totals.get(dt, 0))
        # every leaf starts on a 256-byte boundary
        totals[dt] = offsets[-1] + -(-math.prod(shape) // 128) * 128
    flat = {dt: torch.randn(n, generator=gen, dtype=dt, device=device)
            for dt, n in totals.items()}
    tree: dict = {}
    for (path, shape, kind, dt), off in zip(leaves, offsets):
        t = flat[dt][off:off + math.prod(shape)].view(shape)
        if kind == "linear":
            t.mul_(shape[-2] ** -0.5)
        elif kind == "a_log":
            n = shape[-1]
            t.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                           device=device)).expand(shape))
        else:
            t.mul_(INIT_SCALES[kind])
            if kind in ("norm", "d_skip"):
                t.add_(1.0)
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int)
                                       else {})
        node[path[-1]] = t
    return tree


def sample_indices(traffic: dict, seed: int) -> list[int]:
    """The requests of the window whose logits are checked: ``sample`` of
    the first ``sample_from``, drawn from the seed."""
    return sorted(random.Random(seed).sample(range(traffic["sample_from"]),
                                             traffic["sample"]))


def make_pool(cfg: dict, traffic: dict, seed: int, device: str
              ) -> torch.Tensor:
    """``pool`` prompts of ``[batch, seq]`` ids, uniform over the
    vocabulary, drawn on ``device`` from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    return torch.randint(0, cfg["vocab_size"],
                         (traffic["pool"], traffic["batch"], traffic["seq"]),
                         generator=gen, device=device)


# -- the program -----------------------------------------------------------------

def port_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file: each key that
    names a field passed to it, ``OWN_KEYS`` and the other ``published``
    keys left out; raises KeyError, naming the key and the file, for any
    other key."""
    from repro_torch.configs.base import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    skip = set(OWN_KEYS) | (set(cfg.get("published", ())) - fields)
    where = f"configs/{cfg.get('name')}.json"
    return _fields_of(ModelConfig, {k: v for k, v in cfg.items()
                                    if k not in skip}, where, "")


def _fields_of(cls: type, values: dict, where: str, prefix: str):
    """``cls(**values)``, each value made what its field holds: a dict the
    dataclass of the field's type, a list a tuple, ``dtype`` a
    ``torch.dtype`` by name."""
    names = {f.name for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls)
    kw = {}
    for key, value in values.items():
        if key not in names:
            raise KeyError(f"{prefix + key!r} in {where} is not a field of "
                           f"the port's {cls.__name__}, one of the "
                           f"benchmark's own keys {OWN_KEYS} or a key "
                           "listed under 'published'")
        types = typing.get_args(hints[key]) or (hints[key],)
        group = next((t for t in types if dataclasses.is_dataclass(t)),
                     None)
        if key == "dtype":
            value = DTYPES[value]
        elif isinstance(value, dict) and group is not None:
            value = _fields_of(group, value, where, f"{prefix}{key}.")
        elif isinstance(value, list):
            value = tuple(value)
        kw[key] = value
    return cls(**kw)


def compile_program(cfg: dict, weights: dict, batch: int, seq: int,
                    first: torch.Tensor, device: str):
    """``build_lm_opgraph`` → ``Session(autotune).compile``: the README's
    main path, with the calibration tier under ``build/portbench``."""
    from repro_torch.core import Session, SessionConfig, SimConfig
    from repro_torch.core.graph import OpKind
    from repro_torch.core.profiler import H100_SXM
    from repro_torch.models.opgraph_export import build_lm_opgraph

    graph = build_lm_opgraph(port_config(cfg), batch, seq, weights)
    root = next(n.op_id for n in graph if n.kind == OpKind.INPUT)
    extra = {} if device == "cuda" else {"device": "cpu", "hw": H100_SXM}
    session = Session(SessionConfig(
        autotune=True, sim_cfg=SimConfig(head_of_line=True),
        calib_dir=str(BUILD / "calib"), **extra))
    return graph, session.compile(graph, inputs={root: first})


def describe_program(model) -> None:
    plan = model.plan
    exe = model.executable
    say(f"[program] pick: alloc {plan.alloc_policy} order "
        f"{plan.order_policy} repack {plan.repacked} (est "
        f"{plan.est_makespan_us:.3f} us of {plan.n_candidates} candidates)")
    explain = model.explain()
    say("[program] compile " + json.dumps(
        {"cache": explain["cache"], "timings_ms": model.timings_ms,
         "schedule": explain["schedule"]}))
    say("[program] lane_stats " + json.dumps(exe.lane_stats()))
    say("[program] program_stats " + json.dumps(exe.program_stats()))
    if exe.replay is not None:
        say("[program] recorded_launches "
            + json.dumps(exe.replay.recorded_launches))


# -- the trace ---------------------------------------------------------------------

def kernel_classes() -> dict[str, tuple[list, list]]:
    spec = read_json(HERE / "yardstick" / "kernel_classes.json")["classes"]
    return {name: ([re.compile(p) for p in c["include"]],
                   [re.compile(p) for p in c["exclude"]])
            for name, c in spec.items()}


def class_of(name: str, classes: dict) -> str | None:
    for cls, (inc, exc) in classes.items():
        if any(p.search(name) for p in inc) and not any(
                p.search(name) for p in exc):
            return cls
    return None


def summarize_trace(events, n_forwards: int, window_s: float) -> dict:
    """Busy, overlap, per-class busy, the top device operations and the
    idle gaps named by the host activity beside them, from
    ``(name, is_device, start_ns, end_ns)`` events."""
    from portbench.yardstick.intervals import busy_and_overlap, gaps

    dev = [(n, a, b) for n, is_dev, a, b in events if is_dev and b > a]
    host = [(n, a, b) for n, is_dev, a, b in events if not is_dev and b > a]
    busy_ns, overlap_ns = busy_and_overlap([(a, b) for _, a, b in dev])
    classes = kernel_classes()
    by_class: dict[str, list] = {c: [] for c in classes}
    classed: dict[str, set] = {c: set() for c in classes}
    unclassed: dict[str, float] = {}
    by_name: dict[str, float] = {}
    cls_of: dict[str, str | None] = {}
    for n, a, b in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
        if n not in cls_of:
            cls_of[n] = class_of(n, classes)
        cls = cls_of[n]
        if cls is None:
            unclassed[n] = unclassed.get(n, 0.0) + (b - a)
        else:
            by_class[cls].append((a, b))
            classed[cls].add(n)
    for cls in classes:
        say(f"[trace] class {cls}: {len(classed[cls])} kernels "
            + json.dumps(sorted(k[:160] for k in classed[cls])))
    say(f"[trace] unclassed: {len(unclassed)} kernels " + json.dumps(
        [[k[:160], round(v / n_forwards / 1e9, 9)] for k, v in
         sorted(unclassed.items(), key=lambda kv: -kv[1])[:40]]))
    idle: dict[str, float] = {}
    if dev:
        lo = min(a for _, a, _ in dev + host)
        hi = max(b for _, _, b in dev + host)
        idle = idle_by_host(gaps([(x, y) for _, x, y in dev], lo, hi), host)
    per = 1e9 * n_forwards
    return {
        "n_forwards": n_forwards, "window_s": window_s,
        "busy_s": busy_ns / 1e9, "overlap_s": overlap_ns / 1e9,
        "class_busy_s": {c: busy_and_overlap(v)[0] / 1e9
                         for c, v in by_class.items()},
        "device_ops": [[n[:200], v / per] for n, v in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[n[:200], v / per] for n, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def idle_by_host(idle: list, host: list) -> dict[str, float]:
    """The idle stretches ``[(start, end)]`` summed by the host event that
    covers most of each (the shortest such event, so the innermost call),
    or by "host (no traced call)"."""
    import numpy as np

    out: dict[str, float] = {}
    if not idle:
        return out
    host = sorted(host, key=lambda e: e[2] - e[1])
    hs = np.array([a for _, a, _ in host], dtype=np.float64)
    he = np.array([b for _, _, b in host], dtype=np.float64)
    for k in range(0, len(idle), 4096):
        part = np.array(idle[k:k + 4096], dtype=np.float64)
        length = part[:, 1] - part[:, 0]
        if len(host):
            cover = (np.minimum(part[:, 1:2], he[None])
                     - np.maximum(part[:, 0:1], hs[None]))
            best = cover.argmax(axis=1)
            hit = cover[np.arange(len(part)), best] > 0
        else:
            best = hit = np.zeros(len(part), dtype=bool)
        for j in range(len(part)):
            name = host[best[j]][0] if hit[j] else "host (no traced call)"
            out[name] = out.get(name, 0.0) + float(length[j])
    return out


def traced_window(call: Callable[[int], Any], n: int, sync) -> dict:
    """``n`` back-to-back forwards under ``torch.profiler``, each ended by
    a synchronize as in the window; the events read from kineto."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for j in range(n):
            call(j)
            sync()
        window_s = time.perf_counter() - t0
    events = [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
               e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return summarize_trace(events, n, window_s)


# -- the check ----------------------------------------------------------------------

def compare(cfg: dict, weights: dict, ids: torch.Tensor, got: torch.Tensor,
            quant: str | None = None, block: int = 8) -> dict:
    """The reference over ``ids [R,S]`` against the program's logits
    ``got [R,S,V]``: the largest relative L2 gap of a row (over its whole
    ``[S, V]`` logits) and of one position (over ``V``)."""
    from portbench.reference.common import exact_fp32, logits

    ref = reference_module(cfg)
    row = pos = 0.0
    for r0 in range(0, ids.shape[0], block):
        h = ref.hidden(cfg, weights, ids[r0:r0 + block], quant)
        for r in range(h.shape[0]):
            with exact_fp32(), torch.no_grad():
                want = logits(cfg, weights, h[r], quant)
            g = got[r0 + r].to(want.device, torch.float32)
            if not bool(torch.isfinite(g).all()):
                return {"row_rel_l2": math.inf, "pos_rel_l2": math.inf}
            diff = (g - want).norm(dim=-1)
            norm = want.norm(dim=-1)
            row = max(row, float(diff.norm() / norm.norm()))
            pos = max(pos, float((diff / norm).max()))
            del want, g
    return {"row_rel_l2": row, "pos_rel_l2": pos}


def timeline(lat: list[float], step_s: float) -> list[float]:
    """The mean of consecutive latencies, in ms, per ``step_s`` of the
    time they fill."""
    out, acc, k = [], [], 1
    elapsed = 0.0
    for x in lat:
        elapsed += x
        acc.append(x)
        if elapsed >= k * step_s:
            out.append(round(1e3 * sum(acc) / len(acc), 4))
            acc, k = [], k + 1
    if acc:
        out.append(round(1e3 * sum(acc) / len(acc), 4))
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


# -- one run --------------------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             wrap: Callable | None = None) -> dict:
    """One run of ``cell``; returns the result line as a dict.  ``wrap``
    (tests only) wraps the compiled model's call, to break the timed path
    underneath a run."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, traffic = cell.cfg, cell.traffic
    b, s = traffic["batch"], traffic["seq"]
    cuda = device == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize()

    marks = [("start", t_start)]

    def mark(what: str) -> None:
        sync()
        marks.append((what, time.perf_counter()))

    mark("interpreter, imports, CUDA context")
    weights = make_weights(cfg, seed, device)
    pool = make_pool(cfg, traffic, seed, device)
    mark("weights and prompts")
    graph, model = compile_program(cfg, weights, b, s, pool[0], device)
    mark("build_lm_opgraph + Session.compile")
    if cuda:
        # the peak from here on: the calibration pass that a checkout's
        # first run makes (every intermediate of the graph kept at once)
        # is left out, so every run reads the same set-up
        torch.cuda.reset_peak_memory_stats()
    call = model if wrap is None else wrap(model)
    for i in range(traffic["warmup"]):
        call({"tokens": pool[-1 - i]})
        mark("the first call (warm-up walk, CUDA graph record, replay)"
             if i == 0 else f"warm-up call {i + 1}")
    # back-to-back forwards until the card runs the graph at its steady
    # rate: a fresh process's first seconds of replays run ~9% slower on
    # the card (PERF.md section 7), and this phase ends most of them
    warm: list[float] = []
    t_warm = time.perf_counter()
    while time.perf_counter() - t_warm < traffic["warmup_seconds"]:
        t0 = time.perf_counter()
        call({"tokens": pool[len(warm) % pool.shape[0]]})
        sync()
        warm.append(time.perf_counter() - t0)
    mark(f"{len(warm)} forwards of sustained warm-up")
    describe_program(model)
    say("[setup] " + json.dumps({what: round(t - marks[k][1], 6) for k, (
        what, t) in enumerate(marks[1:])}) + "; warm-up mean ms by 5 s "
        + json.dumps(timeline(warm, 5.0)))

    n_pool = pool.shape[0]
    sample = set(sample_indices(traffic, seed))
    kept: dict[int, torch.Tensor] = {}
    lat: list[float] = []
    failed = 0
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    deadline = t_win + seconds
    t_end = t_win
    i = 0
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        outs = call({"tokens": pool[i % n_pool]})
        sync()
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        if i in sample:
            kept[i] = outs[-1]
        del outs
        i += 1
    n = len(lat)
    if len(kept) < len(sample):
        raise RuntimeError(f"the window ended after {n} forwards, before "
                           f"its sample (first {traffic['sample_from']})")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = {
        "forward_ms": 1e3 * (t_end - t_win) / n,
        # a window of one forward (a loaded CPU's) has no quantiles
        "forward_p95_ms": 1e3 * (statistics.quantiles(
            lat, n=100, method="inclusive")[94] if n > 1 else lat[0]),
        "peak_mem_gib": peak / GIB,
        "setup_s": setup_s,
    }
    say(f"[window] {n} forwards in {t_end - t_win:.3f} s; set-up "
        f"{setup_s:.3f} s; forward ms median "
        f"{1e3 * statistics.median(lat):.4f}; mean ms by 5 s of the window "
        + json.dumps(timeline(lat, 5.0)))

    trace_summary = None
    if trace:
        k = max(3, round(traffic["trace_seconds"] / (t_end - t_win) * n))
        trace_summary = traced_window(
            lambda j: call({"tokens": pool[(i + j) % n_pool]}), k, sync)
    ctx = {"cfg": cfg, "batch": b, "seq": s, "family": family_module(cfg),
           "forward_s": (t_end - t_win) / n,
           "compile_timings_ms": dict(model.timings_ms),
           "trace": trace_summary,
           "peaks": read_json(HERE / "yardstick" / "peaks.json")}

    # the program's state goes before the reference runs
    del call, model, graph
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    order = sorted(kept)
    ids = torch.cat([pool[j % n_pool] for j in order])
    got = torch.cat([kept.pop(j) for j in order])
    checks = compare(cfg, weights, ids, got)

    metrics: dict[str, dict] = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result: dict[str, Any] = {"correct": None, "attempted": n,
                              "failed": failed, "metrics": metrics,
                              "device": dev}
    if trace_summary is not None:
        dev["busy_s"] = trace_summary["busy_s"]
        dev["window_s"] = trace_summary["window_s"]
        result["breakdown"] = {"device_ops": trace_summary["device_ops"],
                               "idle_gaps": trace_summary["idle_gaps"]}
    limits = cell.limits
    result["correct"] = failed == 0 and all(
        checks[k] <= limits[k] for k in checks)
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    return result


def main(argv: list[str], t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    chips = next((w.get("chips", 1) for w in
                  (manifest() or {}).get("workloads", [])
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    seed = args.seed & (2 ** 63 - 1)
    result = run_cell(cell, seed, args.seconds, bool(args.trace),
                      t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded that may not be: {found}",
              file=sys.stderr)
        return 3
    print(f"correct {result['correct']}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
