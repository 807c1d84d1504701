"""Smoke run of the PyTorch/CUDA port on one H100: build the kernels, hold
them against their plain versions, then drive the main path end to end.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits non-zero):
  1. environment: card name and power limit, torch/CUDA versions, kernel
     build time;
  2. kernels vs plain at the main path's shapes (plus an off-lattice shape
     and fp32): error, kernel / plain / library times, bound;
  3. main path: full-width Qwen2-0.5B prefill graph (24 layers, batch 1,
     seq 512, bf16, random weights from --seed) → Session with measured
     calibration and autotune → lowering → one CUDA graph → 3 requests by
     replay, each held against eager per-op execution on the card;
  4. ragged capture: a hand-built ragged matmul fan-out captured into a CUDA
     graph through the grouped_gemm kernel, held against per-op execution.
The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package; needs the repository's ``src/`` next to this file and a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

# -- tolerances ---------------------------------------------------------------
# Kernel vs plain, bf16: both accumulate in fp32 and round once to bf16, so
# they differ by at most about one bf16 ulp (2^-8 relative).
BF16_TOL = 1e-2                 # atol = rtol
# Kernel vs plain, fp32 (TF32 off on both sides): summation order only.
FP32_TOL = 1e-5                 # relative to max|plain|
# Main path vs eager per-op execution: the same payloads, except that the
# fused GEMMs replace 48 cuBLAS calls.  Both accumulate in fp32 and round
# once to bf16, but need not sum in the same order, so a bf16 activation
# may differ by an ulp and the difference runs through 24 layers.  The
# bound is the JAX package's bf16 differential tolerance, kept although
# the H100 runs so far gave bit-equal logits, because nothing guarantees
# cuBLAS's summation order.
LOGITS_REL_L2 = 2e-2
TOP1_AGREE = 0.99               # greedy tokens equal on >= 99% of positions

BATCH, SEQ = 1, 512
TIMING_ITERS = 20
L2_FLUSH_BYTES = 64 * 2**20     # > the H100's 50 MB L2
# GPU-side spin before each timed kernel run, so the host's wrapper work is
# enqueued while the card is still busy and stays out of the event pair
HOLD_CYCLES = 1_000_000         # about 0.5 ms at the H100's clocks

# the calibration disk tier stays inside the checkout (git-ignored)
CALIB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "calib")

# fp32 CUDA-core peak (FLOP/s) per H100 part, NVIDIA H100 data sheet; bf16
# peaks and memory bandwidth come from repro_torch.core.profiler's specs
FP32_PEAK = {"h100-sxm": 67e12, "h100-pcie": 51e12, "h100-nvl": 60e12}


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, iters: int = TIMING_ITERS, warmup: int = 3,
            flush: torch.Tensor | None = None) -> float:
    """Median time of ``fn`` in ms over ``iters`` runs, each between two
    CUDA events.  With ``flush`` (a scratch buffer) — the kernel timings —
    the buffer is overwritten before each run so the run starts with a cold
    L2, and the card spins before the start event so the time is the
    device's alone; without it — the per-forward timings — host gaps inside
    the run count, as a caller sees them."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
            torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gemm_bound_ms(n_flops: float, n_bytes: float, peak: float,
                  bw: float) -> tuple[float, str]:
    t_ops, t_bytes = n_flops / peak, n_bytes / bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


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


# =============================================================================
# 1. environment
# =============================================================================

def phase_environment() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}")
    from repro_torch.core.profiler import detect_hardware
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s) "
        f"-> {_build.library_path().name}")
    kernel = ""
    for line in _build.build_log.splitlines():
        found = re.search(r"(branch|grouped)_gemm_kernelI(f|13__nv_bfloat16)",
                          line)
        if "Compiling entry function" in line and found:
            kernel = (f"{found.group(1)}_gemm<"
                      f"{'fp32' if found.group(2) == 'f' else 'bf16'}>")
        elif "registers" in line or "spill" in line:
            log(f"[build] {kernel}: {line.replace('ptxas info    :', '').strip()}")
    hw = detect_hardware()
    log(f"[env] hardware spec {hw.name}: {hw.peak_flops:.4g} FLOP/s bf16, "
        f"{hw.hbm_bw:.4g} B/s")
    return {"hw": hw, "smi": smi}


# =============================================================================
# 2. kernels vs plain
# =============================================================================

def phase_kernels(env: dict, gen: torch.Generator) -> dict:
    from repro_torch.kernels.branch_gemm import ops as bops
    from repro_torch.kernels.branch_gemm.ref import branch_gemm_ref
    from repro_torch.kernels.grouped_gemm import ops as gops
    from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref

    hw = env["hw"]
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    results = {}

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    def peak(dtype):
        return hw.peak_flops if dtype == torch.bfloat16 else FP32_PEAK[hw.name]

    # branch_gemm: gate||up and wk||wv of the main path, off-lattice, fp32
    for tag, (n, m, k, f), dtype in [
            ("gate||up", (2, 512, 896, 4864), torch.bfloat16),
            ("wk||wv", (2, 512, 896, 128), torch.bfloat16),
            ("off-lattice", (3, 77, 200, 136), torch.bfloat16),
            ("off-lattice fp32", (3, 77, 200, 136), torch.float32),
            ("gate||up fp32", (2, 512, 896, 4864), torch.float32)]:
        x, w = rnd((n, m, k), dtype), rnd((n, k, f), dtype, k ** -0.5)
        launches0 = bops.launches
        got = bops.branch_gemm(x, w)
        want = branch_gemm_ref(x, w)
        torch.cuda.synchronize()
        err = check_close(got, want, f"branch_gemm {tag}")
        size = x.element_size()
        bound, by = gemm_bound_ms(2.0 * n * m * k * f,
                                  size * (n * m * k + n * k * f + n * m * f),
                                  peak(dtype), hw.hbm_bw)
        kernel_ms = cuda_ms(lambda: bops.branch_gemm(x, w), flush=flush)
        plain_ms = cuda_ms(lambda: branch_gemm_ref(x, w), flush=flush)
        library_ms = cuda_ms(lambda: torch.bmm(x, w), flush=flush)
        log(f"[kernel] branch_gemm {tag} [{n},{m},{k}]@[{n},{k},{f}] "
            f"{str(dtype).removeprefix('torch.')}: max_abs_err {err:.3g} "
            f"kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms(bmm) {library_ms:.4f} bound_us {bound * 1e3:.2f} "
            f"({by}) launches {bops.launches - launches0}")
        results[("branch_gemm", tag)] = dict(
            max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=library_ms)

    # grouped_gemm: ragged sizes with a zero-row group, K=896, F=4864
    for tag, sizes, dtype in [("ragged", (0, 37, 512, 5), torch.bfloat16),
                              ("ragged fp32", (0, 37, 512, 5), torch.float32)]:
        k, f = 896, 4864
        x = rnd((sum(sizes), k), dtype)
        w = rnd((len(sizes), k, f), dtype, k ** -0.5)
        table = gops.tile_table(sizes, "cuda")
        launches0 = gops.launches
        got = gops.grouped_gemm(x, w, sizes, table)
        want = grouped_gemm_ref(x, w, sizes)
        torch.cuda.synchronize()
        err = check_close(got, want, f"grouped_gemm {tag}")
        size = x.element_size()
        n_nonempty = sum(1 for m in sizes if m)
        total = sum(sizes)
        # each input read once (only non-empty groups' weights are needed)
        bound, by = gemm_bound_ms(2.0 * total * k * f,
                                  size * (total * k + n_nonempty * k * f
                                          + total * f),
                                  peak(dtype), hw.hbm_bw)
        kernel_ms = cuda_ms(lambda: gops.grouped_gemm(x, w, sizes, table),
                            flush=flush)
        plain_ms = cuda_ms(lambda: grouped_gemm_ref(x, w, sizes), flush=flush)
        library_ms = None
        if dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
            offs = torch.tensor(sizes, device="cuda").cumsum(0).to(torch.int32)
            # the library's kernel takes its weights column-major
            w_cm = w.transpose(-2, -1).contiguous().transpose(-2, -1)
            try:
                lib_out = torch._grouped_mm(x, w_cm, offs=offs)
                torch.cuda.synchronize()
            except RuntimeError as exc:   # not offered for this card/dtype
                log(f"[kernel] torch._grouped_mm unavailable: {exc}")
            else:
                lib_err = float((lib_out.float() - want.float()).abs().max())
                library_ms = cuda_ms(
                    lambda: torch._grouped_mm(x, w_cm, offs=offs), flush=flush)
                log(f"[kernel] torch._grouped_mm max_abs_err vs plain "
                    f"{lib_err:.3g}")
        lib_text = "none" if library_ms is None else f"{library_ms:.4f}"
        log(f"[kernel] grouped_gemm {tag} sizes={sizes} K={k} F={f} "
            f"{str(dtype).removeprefix('torch.')}: max_abs_err {err:.3g} "
            f"kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms(_grouped_mm) {lib_text} bound_us {bound * 1e3:.2f} "
            f"({by}) launches {gops.launches - launches0}")
        results[("grouped_gemm", tag)] = dict(
            max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=library_ms)
    del flush
    return results


# =============================================================================
# 3. main path
# =============================================================================

def phase_main_path(seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import Session, SessionConfig, SimConfig
    from repro_torch.core.capture import run_sequential_uncompiled
    from repro_torch.kernels.branch_gemm import ops as bops
    from repro_torch.kernels.grouped_gemm import ops as gops
    from repro_torch.models.opgraph_export import build_lm_opgraph
    from repro_torch.models.transformer import init_lm

    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = init_lm(cfg, gen, device="cuda")
    graph = build_lm_opgraph(cfg, batch=BATCH, seq=SEQ, params=params)
    torch.cuda.synchronize()
    log(f"[main] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} {str(cfg.dtype).removeprefix('torch.')} "
        f"batch={BATCH} seq={SEQ}: {len(graph)} ops, init+export "
        f"{time.perf_counter() - t0:.2f} s")

    def tokens(i):
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + i)
        return torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g,
                             device="cuda")

    root = next(n.op_id for n in graph if n.fn is None)
    # -- the main path's run: launch counts from 0 -------------------------
    bops.launches = 0
    gops.launches = 0
    sess = Session(SessionConfig(autotune=True,
                                 sim_cfg=SimConfig(head_of_line=True),
                                 calib_dir=CALIB_DIR))
    t0 = time.perf_counter()
    model = sess.compile(graph, inputs={root: tokens(0)})
    compile_s = time.perf_counter() - t0
    exe = model.executable
    stats = exe.program_stats()
    explain = model.explain()
    log(f"[main] compile {compile_s:.2f} s; stages_ms "
        + json.dumps({k: round(v, 3) for k, v in explain["stages_ms"].items()}))
    log(f"[main] cache {json.dumps(explain['cache'])} schedule "
        f"{json.dumps(explain['schedule'])}")
    log(f"[main] program_stats {json.dumps(stats)}")
    n_branch = int(stats["n_branch_gemm"])
    if n_branch <= 0:
        raise AssertionError("the main path lowered no branch_gemm step")

    outputs = []
    first_request_s = None
    for i in range(3):
        inputs = {"tokens": tokens(100 + i)}
        t0 = time.perf_counter()
        outs = model(inputs)
        torch.cuda.synchronize()
        if first_request_s is None:
            first_request_s = time.perf_counter() - t0
        outputs.append((inputs, outs))
    launches = {"branch_gemm": bops.launches, "grouped_gemm": gops.launches}
    # -- end of the main path's run ------------------------------------------
    recorded = exe.replay.recorded_launches
    log(f"[main] first request (warm-up + CUDA-graph record + replay) "
        f"{first_request_s:.3f} s; launches in the graph {recorded}; "
        f"wrapper launches over the run {launches}")
    if recorded["branch_gemm"] != n_branch:
        raise AssertionError(f"{recorded['branch_gemm']} branch_gemm launches "
                             f"recorded, program has {n_branch} steps")

    for i, (inputs, outs) in enumerate(outputs):
        ref = run_sequential_uncompiled(graph, inputs, exe.output_ids)
        got, want = outs[-1].float(), ref[-1].float()
        if got.shape != (BATCH, SEQ, cfg.vocab_size):
            raise AssertionError(f"logits shape {tuple(got.shape)}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("non-finite logits")
        rel = float((got - want).norm() / want.norm())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        log(f"[main] request {i}: logits rel_l2 {rel:.3e} (<= {LOGITS_REL_L2}) "
            f"top1 agreement {agree:.4f} (>= {TOP1_AGREE}) max_abs "
            f"{float((got - want).abs().max()):.3g}")
        if rel > LOGITS_REL_L2 or agree < TOP1_AGREE:
            raise AssertionError(f"request {i} disagrees with the sequential "
                                 "baseline")
    if torch.equal(outputs[0][1][-1], outputs[1][1][-1]):
        raise AssertionError("two different requests gave identical logits")

    inputs = outputs[0][0]
    seq_ms = cuda_ms(lambda: run_sequential_uncompiled(graph, inputs,
                                                       exe.output_ids))
    walk_ms = cuda_ms(lambda: exe.call_uncompiled(inputs))
    replay_ms = cuda_ms(lambda: model(inputs))
    graph_only_ms = cuda_ms(exe.replay.graph.replay)
    log(f"[main] per-forward ms (median of {TIMING_ITERS}): sequential eager "
        f"{seq_ms:.3f}, eager step walk {walk_ms:.3f}, CUDA-graph replay "
        f"{replay_ms:.3f} (graph alone {graph_only_ms:.3f})")
    profile_replay(exe.replay.graph.replay)
    return {"launches": launches, "recorded": recorded}


def profile_replay(replay, n: int = 3) -> None:
    """Device time per forward by kernel, from torch.profiler over ``n``
    graph replays, against the wall time of the same window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            replay()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        if dev_us > 0 and getattr(e, "device_type", None) is not None \
                and "cuda" in str(e.device_type).lower():
            rows.append((dev_us / n / 1e3, e.count // n, e.key))
    total = sum(r[0] for r in rows)
    if not rows:
        log("[profile] torch.profiler recorded no device time")
        return
    log(f"[profile] per forward: device busy {total:.3f} ms of wall "
        f"{wall_ms:.3f} ms (idle share {max(0.0, 1 - total / wall_ms):.3f})")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"[profile] {ms:8.3f} ms {count:5d}x  {key[:90]}")


# =============================================================================
# 4. ragged capture
# =============================================================================

def _mm(x, w):
    return x @ w


def build_ragged_graph(sizes, k, f, dtype, gen):
    """N parallel matmul branches sharing (K, F) with unequal M — the MoE
    expert fan-out shape, hand-built on the card."""
    from repro_torch.core.graph import OpGraph, OpKind
    from repro_torch.core.profiler import gemm_cost
    g = OpGraph("ragged")
    for i, m in enumerate(sizes):
        x = g.add(f"x{i}", OpKind.INPUT, out_shape=(m, k), out_dtype=dtype)
        w = (torch.randn((k, f), generator=gen, device="cuda") * k ** -0.5
             ).to(dtype)
        g.add(f"gemm{i}", OpKind.GEMM, [x], fn=_mm,
              cost=gemm_cost(m, k, f, 4), fuse_sig=("gemm", k, f, False),
              consts=(w,), payload="matmul", out_shape=(m, f),
              out_dtype=dtype)
    g.validate()
    return g


def phase_ragged(gen: torch.Generator) -> dict:
    from repro_torch.core import Session, SessionConfig
    from repro_torch.core.capture import run_sequential_uncompiled
    from repro_torch.kernels.branch_gemm import ops as bops
    from repro_torch.kernels.grouped_gemm import ops as gops

    bops.launches = 0
    gops.launches = 0
    for sizes, k, f, dtype in [((8, 24, 16), 128, 128, torch.float32),
                               ((0, 37, 512, 5), 896, 4864, torch.bfloat16)]:
        g = build_ragged_graph(sizes, k, f, dtype, gen)
        model = Session(SessionConfig(calib_dir=CALIB_DIR)).compile(g)
        stats = model.executable.program_stats()
        if stats["n_grouped_gemm"] != 1:
            raise AssertionError(f"ragged graph {sizes}: {stats}")
        inputs = {n.name: torch.randn(n.out_shape, generator=gen,
                                      device="cuda").to(dtype)
                  for n in g if n.fn is None}
        outs = model(inputs)
        recorded = model.executable.replay.recorded_launches
        if recorded["grouped_gemm"] != 1:
            raise AssertionError(f"{recorded} grouped_gemm launches recorded")
        ref = run_sequential_uncompiled(g, inputs, model.executable.output_ids)
        err = max((check_close(a, b, f"ragged capture {sizes}")
                   for a, b in zip(outs, ref)), default=0.0)
        log(f"[ragged] sizes={sizes} K={k} F={f} "
            f"{str(dtype).removeprefix('torch.')}: one grouped_gemm step, "
            f"{recorded['grouped_gemm']} launch in the graph, replay vs "
            f"per-op max_abs_err {err:.3g}")
    launches = {"branch_gemm": bops.launches, "grouped_gemm": gops.launches}
    log(f"[ragged] wrapper launches over the phase {launches}")
    return {"launches": launches}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    env = phase_environment()
    kernels = phase_kernels(env, gen)
    main_path = phase_main_path(args.seed)
    ragged = phase_ragged(gen)

    for path, launches in (("main", main_path["launches"]["branch_gemm"]),
                           ("ragged", ragged["launches"]["grouped_gemm"])):
        if launches <= 0:
            raise AssertionError(f"the {path} path launched no kernel")
    summary = {"kernels": [
        dict(name="branch_gemm", route="cuda",
             source="src/repro_torch/csrc/gemm.cu",
             replaces="src/repro/kernels/branch_gemm/kernel.py:46",
             launches=main_path["launches"]["branch_gemm"],
             **kernels[("branch_gemm", "gate||up")]),
        dict(name="grouped_gemm", route="cuda",
             source="src/repro_torch/csrc/gemm.cu",
             replaces="src/repro/kernels/grouped_gemm/kernel.py:52",
             launches=ragged["launches"]["grouped_gemm"],
             **kernels[("grouped_gemm", "ragged")]),
    ]}
    log(env["smi"].splitlines()[0])
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
