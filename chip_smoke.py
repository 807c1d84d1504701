"""Smoke run of the PyTorch/CUDA port on one H100: build the kernels, hold
them against their plain versions, then drive the main path end to end.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits non-zero):
  1. environment: card name and power limit, torch/CUDA versions, kernel
     build time, ptxas registers and remarks (a remark on the flash, the
     moe_gemm or the MLA wgmma kernels, e.g. serialised wgmma, fails the
     run);
  2. kernels vs plain at the main path's shapes (plus an off-lattice shape
     and fp32): route, error, kernel / plain / library times, bound,
     TFLOP/s and share of the bound; for bf16 also the simple route (the
     WMMA routine the wgmma route replaced) at the same shape;
  3. main path: full-width Qwen2-0.5B prefill graph (24 layers, batch 1,
     seq 512, bf16, random weights from --seed) → Session with measured
     calibration and autotune → lowering → one CUDA graph → 3 requests by
     replay, each held against eager per-op execution on the card; every
     GEMM launch of this and the other op-graph phases (4, 8, 9, 10) on the
     wgmma route (launches counted by route);
  4. ragged capture: a hand-built ragged matmul fan-out captured into a CUDA
     graph through the grouped_gemm kernel, held against per-op execution;
  5. attention kernels: rmsnorm, flash_attention, decode_attention and
     paged_decode vs their plain versions at the serving shapes and at odd
     ones (D = 14, ragged T, null pages, clamped window starts), bf16 and
     fp32: error, kernel / plain / library times, bound; rmsnorm's onepass
     route at every width the registered models normalise (896, 2048, 7168,
     1536, 512) at 512 and 8 rows, beside the simple route (the routine it
     replaced) and F.rms_norm in the same call; flash_attention's
     bf16 prefills (Qwen2-0.5B at 512 and 1024 tokens, Kimi-K2's 64/8 heads
     of 112) with its route, TFLOP/s, share of the bound and the simple
     route (the WMMA routine the wgmma route replaced) at the same shape;
     the decode pair at 8 slots of 1024 positions (Qwen2-0.5B's 14/2 heads
     of 64, Kimi-K2's 64/8 of 112) likewise, beside the simple route (the
     routine the mma route replaced), paged equal to dense bit for bit;
  6. serve: full-width Qwen2-0.5B behind ``Model(use_kernels=True)`` and
     ``InferenceEngine`` (8 slots, 1024 positions), once with the dense KV
     slab and once paged (16-position pages): 16 requests of 17-700 prompt
     tokens and 32 greedy tokens each, two priorities with tick deadlines
     (EDF preemption); paged and dense streams must be equal (in bf16 up
     to a preempted request's resume, in fp32 entirely); the kernel route
     is held against the plain route (prefill logits and 32 teacher-forced
     decode steps, bf16 and fp32); every flash_attention launch of the bf16
     prefills on the wgmma route and every decode_attention and
     paged_decode launch of the bf16 decode ticks on the mma route (here and
     in phase 8); a decode tick by CUDA-graph replay is bit-equal to the
     eager tick; times and a profile of one decode tick;
  7. moe_gemm (Kimi-K2's 384 experts, d 7168, f 2048: a decode tick's
     occupancy, 8 tokens' top-8 at capacity 1 with every other expert's row
     zero, whose bound counts the routed experts' weights only; every expert
     full at capacity 1 and at a 512-token prefill's 13, each beside the
     simple route, the routine the wgmma route replaced, in the same call;
     every expert empty; only the last expert with a row; fp32; off the
     tile lattice; empty experts' rows exactly +0) and rwkv6 (RWKV6-1.6B's
     32 heads of 64 at a 512-token prefill and an 8-slot decode tick, each
     with its route and beside the step route, the routine the chunked
     route replaced, in the same call; strong decays with exact zeros at
     512 and 700 positions; odd T; the model layout read in place; nonzero
     state) vs their plain versions; decode rows with no attended position,
     dense and paged;
  8. Kimi-K2 at full width, 2 of 61 layers (dense prefix + one MoE layer):
     the routed op graph (16 expert branches, batch 1, seq 512) through
     Session.compile into one CUDA graph with grouped_gemm on the fan-out,
     held against eager per-op execution; then the serve trace of phase 6
     on dense and paged engines with moe_gemm (bf16; fp32 at 64 of the 384
     experts), the kernel route held against the plain route (the MoE layer
     on identical inputs; whole-model logits over the positions whose
     expert choice agrees in bf16, over all of them in fp32), paged against
     dense streams, decode ticks graph vs eager; every bf16 moe_gemm
     launch of the serve runs on the wgmma route (here and in phase 9);
  9. DeepSeek-V3 at full width, 4 of 61 layers (3 dense-prefix + 1 MoE,
     MLA attention, the MTP head built): the MLA form of paged decode vs
     plain at the serving shapes (8 slots, 128 heads, Dk 576, Dv 512, 16-
     and 128-position pages, full and ragged lengths, bf16 and fp32; the
     route, its share of the bound and, in bf16, the simple route, the
     routine the wgmma route replaced, in the same call), on rows with no
     attended position and with table entries past each length on a page
     of inf; the routed op graph through
     Session.compile (branch_gemm and grouped_gemm); the serve trace dense
     and paged (bf16, then fp32 at 64 of the 256 experts) with the MLA
     kernel on the paged engine; the kernel route vs the plain route (the
     MLA and MoE layers on identical inputs, whole-model logits, fp32
     teacher-forced decode); every bf16 MLA launch of the serve runs on
     the wgmma route; decode ticks graph vs eager;
 10. RWKV6-1.6B at full width and depth (24 layers): the op graph (seq 512,
     the wkv_scan nodes launch rwkv6, every launch on the chunked route)
     through Session.compile, held against eager per-op execution; the
     serve trace on the dense-slab engine in bf16 and fp32 with phase 6's
     gates; a decode tick graph vs eager; the longest prompt's prefill with
     every rwkv6 launch on the chunked route.
The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package; needs the repository's ``src/`` next to this file and a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
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
# The serve phase holds the kernel route (use_kernels=True) to the plain
# route by the same two numbers: relative L2 in bf16 and fp32, top-1
# agreement in fp32 only (see _check_agreement).
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


# every kernel of the port, in the order of the kernels line
KERNELS = ("branch_gemm", "grouped_gemm", "rmsnorm", "flash_attention",
           "decode_attention", "paged_decode", "paged_decode_mla", "moe_gemm",
           "rwkv6")


def _json_row(result: dict) -> dict:
    """A measurement as the kernels line carries it."""
    return {k: result[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}


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
        f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in "
        f"parallel: {_build.build_seconds:.2f} s) -> "
        f"{[_build.library_path(s).name for s in _build.sources()]}")
    kernel = ""
    for source, text in sorted(_build.build_log.items()):
        for line in text.splitlines():
            found = re.search(r"([a-z_]+_kernel)I(f|13__nv_bfloat16)"
                              r"(?:NS_(\d+)(\w+?)E)?", line)
            wgmma = re.search(r"wg\d+gemm_kernelILi(\d+)ELi(\d+)ELb([01])E",
                              line)
            flash = re.search(r"flash_wgmma_kernelILi(\d+)ELi(\d+)E", line)
            decode = re.search(r"decode_mma_kernelI\w*?(Dense|Paged)KV", line)
            moe = re.search(r"expert_wgmma_kernelILb([01])ELi(\d+)E", line)
            norm = re.search(r"rmsnorm_rows_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                             line)
            mla = re.search(r"mla_wgmma_kernel", line)
            rwkv = re.search(r"rwkv6_(chunk_(state|carry|out)_)?kernel", line)
            name = ""
            if mla:
                name = f"{source}:paged_decode_mla wgmma<bf16, R 512, P 64>"
            elif rwkv:
                name = (f"{source}:rwkv6 chunked<{rwkv[2]}>" if rwkv[1]
                        else f"{source}:rwkv6 step")
            elif moe:
                name = (f"{source}:moe_gemm wgmma<bf16, stage "
                        f"{2 - int(moe[1])}, NT {moe[2]}>")
            elif norm:
                dt = "fp32" if norm[1] == "f" else "bf16"
                name = f"{source}:rmsnorm onepass<{dt}, VPT {norm[2]}>"
            elif wgmma:
                name = (f"{source}:{('branch', 'grouped')[int(wgmma[3])]}"
                        f"_gemm wgmma<bf16, BM {wgmma[1]}, BN {wgmma[2]}>")
            elif flash:
                name = (f"{source}:flash_attention wgmma<bf16, DP {flash[1]}, "
                        f"BKV {flash[2]}>")
            elif decode:
                name = f"{source}:decode mma<bf16, {decode[1]}KV>"
            note = re.search(r"\((C\d{4})\) ([^']*)", line)
            if note:   # a ptxas remark (e.g. serialised wgmma), any kernel
                log(f"[build] {name or source}: {note[1]} {note[2][:110]}")
            elif "Compiling entry function" in line and name:
                kernel = name
            elif "Compiling entry function" in line and found:
                kv = ""
                if found.group(3):
                    kv = ", " + found.group(4)[:int(found.group(3))]
                kernel = (f"{source}:{found.group(1)}<"
                          f"{'fp32' if found.group(2) == 'f' else 'bf16'}{kv}>")
            elif "registers" in line or "spill" in line:
                log(f"[build] {kernel}: "
                    f"{line.replace('ptxas info    :', '').strip()}")
    # a ptxas remark (serialised wgmma, C7512/C7515/C7517/C7518) on the
    # flash, the moe_gemm or the MLA wgmma kernels fails the run: the remark
    # names its function in quotes
    remarks = [
        (m[1], m[2]) for text in _build.build_log.values()
        for m in re.finditer(r"\((C\d{4})\)[^']*'([^']*)'", text)
        if "flash" in m[2] or "expert_wgmma" in m[2]
        or "mla_wgmma" in m[2]]
    if remarks:
        raise AssertionError(f"ptxas remarks on the flash_attention, "
                             f"moe_gemm or MLA wgmma kernels: {remarks}")
    if not _build.build_log:
        log("[build] libraries reused: no ptxas output to check")
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

    def report(name, tag, desc, dtype, err, path, flops, bound, by, kernel_ms,
               simple_ms, plain_ms, library_ms, lib_name, launches):
        """One [kernel] line: the kernel's route and time, the simple route
        (the WMMA routine the wgmma route replaced) at the same shape
        (bf16), the plain version, the library call, the bound, achieved
        TFLOP/s and the share of the bound."""
        simple = ("" if simple_ms is None else
                  f"simple_ms {simple_ms:.4f} ({simple_ms / kernel_ms:.2f}x) ")
        lib_text = "none" if library_ms is None else f"{library_ms:.4f}"
        log(f"[kernel] {name} {tag} {desc} "
            f"{str(dtype).removeprefix('torch.')}: route {path} max_abs_err "
            f"{err:.3g} kernel_ms {kernel_ms:.4f} "
            f"({flops / kernel_ms / 1e9:.1f} TFLOP/s, {bound / kernel_ms:.3f}"
            f" of the bound) {simple}plain_ms {plain_ms:.4f} "
            f"library_ms({lib_name}) {lib_text} bound_us {bound * 1e3:.2f} "
            f"({by}) launches {launches}")
        results[(name, tag)] = dict(
            max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=library_ms, simple_ms=simple_ms,
            route=path)

    # branch_gemm: gate||up and wk||wv of the main path, the equal-shape
    # branches Kimi-K2's and RWKV6's op graphs stack, off-lattice, fp32
    for tag, (n, m, k, f), dtype in [
            ("gate||up", (2, 512, 896, 4864), torch.bfloat16),
            ("wk||wv", (2, 512, 896, 128), torch.bfloat16),
            ("kimi dense-prefix gate||up", (2, 512, 7168, 18432),
             torch.bfloat16),
            ("rwkv wr||wk||wv||wg", (4, 512, 2048, 2048), torch.bfloat16),
            ("off-lattice", (3, 77, 200, 136), torch.bfloat16),
            ("off-lattice fp32", (3, 77, 200, 136), torch.float32),
            ("gate||up fp32", (2, 512, 896, 4864), torch.float32)]:
        x, w = rnd((n, m, k), dtype), rnd((n, k, f), dtype, k ** -0.5)
        launches0 = bops.launches
        path = bops.route(x, w)
        got = bops.branch_gemm(x, w)
        want = branch_gemm_ref(x, w)
        torch.cuda.synchronize()
        err = check_close(got, want, f"branch_gemm {tag}")
        size = x.element_size()
        flops = 2.0 * n * m * k * f
        bound, by = gemm_bound_ms(flops,
                                  size * (n * m * k + n * k * f + n * m * f),
                                  peak(dtype), hw.hbm_bw)
        kernel_ms = cuda_ms(lambda: bops.branch_gemm(x, w), flush=flush)
        simple_ms = None
        if dtype == torch.bfloat16:
            check_close(bops.branch_gemm_simple_bf16(x, w), want,
                        f"branch_gemm simple {tag}")
            simple_ms = cuda_ms(lambda: bops.branch_gemm_simple_bf16(x, w),
                                flush=flush)
        plain_ms = cuda_ms(lambda: branch_gemm_ref(x, w), flush=flush)
        library_ms = cuda_ms(lambda: torch.bmm(x, w), flush=flush)
        report("branch_gemm", tag, f"[{n},{m},{k}]@[{n},{k},{f}]", dtype, err,
               path, flops, bound, by, kernel_ms, simple_ms, plain_ms,
               library_ms, "bmm", bops.launches - launches0)

    # grouped_gemm: ragged sizes with a zero-row group, K=896, F=4864; the
    # routed fan-out of Kimi-K2's op graph at a 512-token prefill (16
    # expert branches, capacities 0.5x-1.5x of the mean load): gate||up
    # K=7168 F=4096, down K=2048 F=7168
    from repro_torch.configs import get_config
    from repro_torch.models.opgraph_export import _moe_capacities
    moe = get_config("kimi-k2-1t-a32b").moe
    kimi_caps = _moe_capacities(BATCH * SEQ, moe, 16, moe.top_k)
    for tag, sizes, (k, f), dtype in [
            ("ragged", (0, 37, 512, 5), (896, 4864), torch.bfloat16),
            ("ragged fp32", (0, 37, 512, 5), (896, 4864), torch.float32),
            ("kimi gate||up", kimi_caps, (7168, 4096), torch.bfloat16),
            ("kimi down", kimi_caps, (2048, 7168), torch.bfloat16)]:
        x = rnd((sum(sizes), k), dtype)
        w = rnd((len(sizes), k, f), dtype, k ** -0.5)
        table = gops.tile_table(sizes, "cuda")
        launches0 = gops.launches
        path = bops.route(x, w)
        got = gops.grouped_gemm(x, w, sizes, table)
        want = grouped_gemm_ref(x, w, sizes)
        torch.cuda.synchronize()
        err = check_close(got, want, f"grouped_gemm {tag}")
        size = x.element_size()
        n_nonempty = sum(1 for m in sizes if m)
        total = sum(sizes)
        flops = 2.0 * total * k * f
        # each input read once (only non-empty groups' weights are needed)
        bound, by = gemm_bound_ms(flops,
                                  size * (total * k + n_nonempty * k * f
                                          + total * f),
                                  peak(dtype), hw.hbm_bw)
        kernel_ms = cuda_ms(lambda: gops.grouped_gemm(x, w, sizes, table),
                            flush=flush)
        simple_ms = None
        if dtype == torch.bfloat16:
            check_close(gops.grouped_gemm_simple_bf16(x, w, sizes, table),
                        want, f"grouped_gemm simple {tag}")
            simple_ms = cuda_ms(
                lambda: gops.grouped_gemm_simple_bf16(x, w, sizes, table),
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
        report("grouped_gemm", tag, f"sizes={sizes} K={k} F={f}", dtype, err,
               path, flops, bound, by, kernel_ms, simple_ms, plain_ms,
               library_ms, "_grouped_mm", gops.launches - launches0)
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
    reset_launches()
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
    routes = gemm_routes()
    # -- end of the main path's run ------------------------------------------
    recorded = exe.replay.recorded_launches
    log(f"[main] first request (warm-up + CUDA-graph record + replay) "
        f"{first_request_s:.3f} s; launches in the graph {recorded}; "
        f"wrapper launches over the run {launches}, by route {routes}")
    check_wgmma_only("main", routes)
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


def profile_replay(replay, n: int = 3, what: str = "forward",
                   tag: str = "profile") -> None:
    """Device time per ``what`` by kernel, from torch.profiler over ``n``
    calls of ``replay``, against the wall time of the same window."""
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
        log(f"[{tag}] torch.profiler recorded no device time")
        return
    log(f"[{tag}] per {what}: device busy {total:.3f} ms of wall "
        f"{wall_ms:.3f} ms (idle share {max(0.0, 1 - total / wall_ms):.3f})")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"[{tag}] {ms:8.3f} ms {count:5d}x  {key[:90]}")


def device_us_by_kernel(calls: dict, n: int = 50) -> dict:
    """Device time per call in us of each function of ``calls`` (label ->
    (fn, kernel-name substring or None for "every other kernel")), from one
    torch.profiler window over ``n`` calls of each, warm L2: the kernels'
    own durations, without the launch and event overhead that cuda_ms
    counts."""
    from torch.profiler import ProfilerActivity, profile
    for fn, _ in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn, _ in calls.values():
            for _ in range(n):
                fn()
        torch.cuda.synchronize()
    totals = dict.fromkeys(calls, 0.0)
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        if not dev_us or "cuda" not in str(
                getattr(e, "device_type", "")).lower():
            continue
        label = next((k for k, (_, sub) in calls.items()
                      if sub is not None and sub in e.key),
                     next(k for k, (_, sub) in calls.items() if sub is None))
        totals[label] += dev_us / n
    return totals


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

    reset_launches()
    for sizes, k, f, dtype in [((8, 24, 16), 128, 128, torch.float32),
                               ((0, 37, 512, 5), 896, 4864, torch.bfloat16)]:
        before = gops.launches_by_route["wgmma" if dtype == torch.bfloat16
                                        else "fp32"]
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
        after = gops.launches_by_route["wgmma" if dtype == torch.bfloat16
                                       else "fp32"]
        if after <= before:
            raise AssertionError(f"ragged {dtype} capture launched no "
                                 f"grouped_gemm on its route")
    launches = {"branch_gemm": bops.launches, "grouped_gemm": gops.launches}
    routes = gemm_routes()
    log(f"[ragged] wrapper launches over the phase {launches}, by route "
        f"{routes} (the fp32 capture takes the fp32 route)")
    if routes["branch_gemm"]["simple"] or routes["grouped_gemm"]["simple"]:
        raise AssertionError(f"ragged capture took the simple route {routes}")
    return {"launches": launches, "routes": routes}


# =============================================================================
# 5. attention kernels
# =============================================================================

# Qwen2-0.5B's serving geometry: heads, KV heads, head dim; 8 decode slots of
# 1024 positions; 16-position pages
HEADS, KV_HEADS, HEAD_DIM = 14, 2, 64
SLOTS, MAX_LEN, PAGE = 8, 1024, 16


def _dt(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _causal_pairs(s: int, t: int, window: int) -> int:
    """(query, key) pairs a causal (windowed) prefill attends."""
    q = np.arange(s)
    keys = np.minimum(q + 1, t)
    if window > 0:
        keys = np.minimum(keys, window)
    return int(keys.sum())


def phase_attention_kernels(env: dict, gen: torch.Generator) -> dict:
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_decode import ops as pops
    from repro_torch.kernels.paged_decode.ref import paged_decode_attention_ref
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    F = torch.nn.functional
    hw = env["hw"]
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    results = {}

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    def measure(name, tag, dtype, err, kernel_fn, plain_fn, library_fn,
                library_label, n_flops, n_bytes, flops_peak=None,
                path=None, simple_fn=None):
        """One [kernel] line; with ``path`` (flash_attention and the decode
        pair) also the route, achieved TFLOP/s, the share of the bound and,
        with ``simple_fn``, the simple route's time at the same shape."""
        peak = flops_peak or (hw.peak_flops if dtype == torch.bfloat16
                              else FP32_PEAK[hw.name])
        bound, by = gemm_bound_ms(n_flops, n_bytes, peak, hw.hbm_bw)
        kernel_ms = cuda_ms(kernel_fn, flush=flush)
        simple_ms = (cuda_ms(simple_fn, flush=flush)
                     if simple_fn is not None else None)
        plain_ms = cuda_ms(plain_fn, flush=flush)
        library_ms = (cuda_ms(library_fn, flush=flush)
                      if library_fn is not None else None)
        lib = "none" if library_ms is None else f"{library_ms:.4f}"
        route = "" if path is None else (
            f"route {path} ({n_flops / kernel_ms / 1e9:.1f} TFLOP/s, "
            f"{bound / kernel_ms:.3f} of the bound) ")
        simple = "" if simple_ms is None else (
            f"simple_ms {simple_ms:.4f} ({simple_ms / kernel_ms:.2f}x) ")
        vs_lib = "" if path is None or library_ms is None else (
            f" ({kernel_ms / library_ms:.2f}x the library)")
        log(f"[kernel] {name} {tag} {_dt(dtype)}: {route}max_abs_err "
            f"{err:.3g} kernel_ms {kernel_ms:.4f} {simple}plain_ms "
            f"{plain_ms:.4f} library_ms({library_label}) {lib}{vs_lib} "
            f"bound_us {bound * 1e3:.3f} ({by}; {n_flops / 1e6:.2f} MFLOP, "
            f"{n_bytes / 1e6:.3f} MB)")
        return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=library_ms)

    # -- rmsnorm: every width the registered models normalise (Qwen2-0.5B
    # 896, RWKV6-1.6B 2048, Kimi-K2 and DeepSeek-V3 7168, DeepSeek-V3's
    # q_norm 1536 and kv_norm 512) at a prefill's 512 rows and a decode
    # tick's 8, each beside the simple route (the routine the onepass route
    # replaced) and F.rms_norm in the same call; fp32; odd shapes ----------
    bf16, fp32 = torch.bfloat16, torch.float32
    norm_cases = [(f"{tag} d={d}", (n, d), bf16, True)
                  for d in (896, 2048, 7168, 1536, 512)
                  for tag, n in (("prefill", 512), ("decode", SLOTS))]
    norm_cases += [("prefill d=896", (512, 896), fp32, True),
                   ("odd", (3, 14), bf16, False),
                   ("odd", (5, 100), fp32, False)]
    for tag, (n, d), dtype, timed in norm_cases:
        x, scale = rnd((n, d), dtype), rnd((d,), dtype)
        path = rops.route(x, scale)
        before = rops.launches_by_route[path]
        got, want = rops.rmsnorm(x, scale), rmsnorm_ref(x, scale)
        torch.cuda.synchronize()
        if rops.launches_by_route[path] != before + 1:
            raise AssertionError(f"rmsnorm {tag} did not count a {path} "
                                 f"launch")
        err = check_close(got, want, f"rmsnorm {tag} [{n},{d}]")
        if not timed:
            log(f"[kernel] rmsnorm {tag} [{n},{d}] {_dt(dtype)}: route {path} "
                f"max_abs_err {err:.3g}")
            continue
        if path != "onepass":
            raise AssertionError(f"rmsnorm {tag} [{n},{d}] took the {path} "
                                 f"route")
        simple_err = check_close(rops.rmsnorm_simple(x, scale), want,
                                 f"rmsnorm simple route {tag} [{n},{d}]")
        lib_err = float((F.rms_norm(x, (d,), scale, 1e-6).float()
                         - want.float()).abs().max())
        log(f"[kernel] rmsnorm {tag}: simple route max_abs_err vs plain "
            f"{simple_err:.3g}, F.rms_norm vs plain {lib_err:.3g}")
        results[("rmsnorm", tag, dtype)] = measure(
            "rmsnorm", f"{tag} [{n},{d}]", dtype, err,
            lambda: rops.rmsnorm(x, scale), lambda: rmsnorm_ref(x, scale),
            lambda: F.rms_norm(x, (d,), scale, 1e-6), "F.rms_norm",
            4.0 * n * d, x.element_size() * (2 * n * d + d),
            flops_peak=FP32_PEAK[hw.name], path=path,
            simple_fn=lambda: rops.rmsnorm_simple(x, scale))
        dev = device_us_by_kernel({
            "onepass": (lambda: rops.rmsnorm(x, scale), "rmsnorm_rows_kernel"),
            "simple": (lambda: rops.rmsnorm_simple(x, scale),
                       "simple::rmsnorm_kernel"),
            "F.rms_norm": (lambda: F.rms_norm(x, (d,), scale, 1e-6), None)})
        log(f"[kernel] rmsnorm {tag} [{n},{d}] {_dt(dtype)}: device time per "
            f"call (torch.profiler, warm L2, 50 calls): " + ", ".join(
                f"{k} {v:.2f} us" for k, v in dev.items()))

    # -- flash attention: the bf16 prefills of the serving paths (Qwen2-0.5B
    # at 512 tokens and at the engine's max_len, Kimi-K2's 64/8 heads of 112),
    # each timed beside the simple route (the WMMA routine the wgmma route
    # replaced) in the same call; fp32; then odd shapes -----------------------
    from repro_torch.configs import get_config
    kimi = get_config("kimi-k2-1t-a32b")
    kimi_heads = (kimi.n_heads, kimi.n_kv_heads, kimi.head_dim)
    for tag, (b, s, h, kvh, d, window), dtype, timed in [
            ("prefill", (1, 512, HEADS, KV_HEADS, HEAD_DIM, 0), bf16, True),
            ("prefill S=1024", (1, MAX_LEN, HEADS, KV_HEADS, HEAD_DIM, 0),
             bf16, True),
            ("kimi prefill", (1, 512, *kimi_heads, 0), bf16, True),
            ("prefill", (1, 512, HEADS, KV_HEADS, HEAD_DIM, 0), fp32, True),
            ("odd D=14 S=77", (2, 77, 4, 2, 14, 0), bf16, False),
            ("odd window=32 S=200", (1, 200, 4, 1, 64, 32), fp32, False),
            ("odd D=128 S=130", (1, 130, 2, 2, 128, 0), bf16, False),
            ("odd D=112 S=200 window=40", (2, 200, 8, 2, 112, 40), bf16,
             False)]:
        q = rnd((b, s, h, d), dtype)
        k, v = rnd((b, s, kvh, d), dtype), rnd((b, s, kvh, d), dtype)
        path = fops.route(q, k, v)
        launches0 = fops.launches_by_route[path]
        got = fops.flash_attention(q, k, v, True, window)
        want = flash_attention_ref(q, k, v, True, window)
        torch.cuda.synchronize()
        if fops.launches_by_route[path] != launches0 + 1:
            raise AssertionError(f"flash_attention {tag}: no {path} launch")
        err = check_close(got, want, f"flash_attention {tag}")
        simple_fn = None
        if dtype == bf16:
            simple_err = check_close(
                fops.flash_attention_simple_bf16(q, k, v, True, window), want,
                f"flash_attention simple {tag}")
            simple_fn = (lambda q=q, k=k, v=v, w=window:
                         fops.flash_attention_simple_bf16(q, k, v, True, w))
        if not timed:
            log(f"[kernel] flash_attention {tag} {_dt(dtype)}: route {path} "
                f"max_abs_err {err:.3g}"
                + ("" if simple_fn is None else
                   f" (simple route {simple_err:.3g})"))
            continue

        def sdpa(q=q, k=k, v=v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)
        lib_err = float((sdpa().transpose(1, 2).float() - want.float())
                        .abs().max())
        log(f"[kernel] SDPA causal max_abs_err vs plain {lib_err:.3g}")
        pairs = _causal_pairs(s, s, window)
        results[("flash_attention", tag, dtype)] = measure(
            "flash_attention", f"{tag} B={b} S=T={s} H={h}/{kvh} D={d}",
            dtype, err,
            lambda q=q, k=k, v=v: fops.flash_attention(q, k, v, True, window),
            lambda q=q, k=k, v=v: flash_attention_ref(q, k, v, True, window),
            sdpa, "SDPA causal gqa", 4.0 * b * h * d * pairs,
            q.element_size() * (2 * b * s * h * d + 2 * b * s * kvh * d),
            path=path, simple_fn=simple_fn)

    # -- decode: 8 slots of 1024 positions, attended up to pos: Qwen2's 14/2
    # heads of 64 (bf16 and fp32) and Kimi-K2's 64/8 heads of 112 (bf16);
    # each bf16 row timed beside the simple route (the routine the mma route
    # replaced) in the same call, dense and through shuffled 16-position
    # pages; the paged decode must equal the dense one bit for bit ----------
    rng = np.random.default_rng(1234)
    pos = torch.tensor(rng.integers(17, MAX_LEN - 24, SLOTS), device="cuda")
    for tag, (h, kvh, d), dtype in [
            ("decode", (HEADS, KV_HEADS, HEAD_DIM), bf16),
            ("decode", (HEADS, KV_HEADS, HEAD_DIM), fp32),
            ("kimi decode", kimi_heads, bf16)]:
        b, t = SLOTS, MAX_LEN
        q = rnd((b, h, d), dtype)
        k, v = rnd((b, t, kvh, d), dtype), rnd((b, t, kvh, d), dtype)
        valid = torch.arange(t, device="cuda")[None] <= pos[:, None]
        path = dops.route(q, k, v)
        if path != ("mma" if dtype == bf16 else "fp32"):
            raise AssertionError(f"decode_attention {tag} {_dt(dtype)} takes "
                                 f"the {path} route")
        by_route = dict(dops.launches_by_route)
        got = dops.decode_attention(q, k, v, valid)
        want = decode_attention_ref(q, k, v, valid)
        torch.cuda.synchronize()
        if dops.launches_by_route[path] != by_route[path] + 1:
            raise AssertionError(f"decode_attention {tag}: no {path} launch")
        err = check_close(got, want, f"decode_attention {tag}")
        mask = valid[:, None, None, :]
        simple_fn = simple_p = None
        if dtype == bf16:
            simple_err = check_close(
                dops.decode_attention_simple_bf16(q, k, v, valid), want,
                f"decode_attention simple {tag}")
            log(f"[kernel] decode_attention {tag}: the simple route "
                f"max_abs_err {simple_err:.3g}")

            def simple_fn(q=q, k=k, v=v, valid=valid):
                return dops.decode_attention_simple_bf16(q, k, v, valid)

        def sdpa(q=q, k=k, v=v, mask=mask):
            return F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        lib_err = float((sdpa()[:, :, 0].float() - want.float()).abs().max())
        log(f"[kernel] SDPA masked max_abs_err vs plain {lib_err:.3g}")
        n_valid = int(valid.sum())
        size = q.element_size()
        results[("decode_attention", tag, dtype)] = measure(
            "decode_attention",
            f"{tag} B={b} T={t} H={h}/{kvh} D={d} ({n_valid} positions "
            "attended)", dtype, err,
            lambda q=q, k=k, v=v, valid=valid: dops.decode_attention(
                q, k, v, valid),
            lambda q=q, k=k, v=v, valid=valid: decode_attention_ref(
                q, k, v, valid), sdpa,
            "SDPA bool mask gqa", 4.0 * h * d * n_valid,
            size * (2 * n_valid * kvh * d + 2 * b * h * d) + b * t,
            path=path, simple_fn=simple_fn)

        # paged: the same positions through shuffled 16-position pages
        maxp = MAX_LEN // PAGE
        n_pages = 1 + b * maxp
        perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                              .manual_seed(5)) + 1
        bt = perm.reshape(b, maxp).to(torch.int32).cuda()
        kp = torch.zeros((n_pages, PAGE, kvh, d), dtype=dtype, device="cuda")
        vp = torch.zeros_like(kp)
        kp[bt.long().flatten()] = k.reshape(b * maxp, PAGE, kvh, d)
        vp[bt.long().flatten()] = v.reshape(b * maxp, PAGE, kvh, d)
        lengths = (pos + 1).to(torch.int32)
        if dops.route(q, kp, vp) != path:
            raise AssertionError(f"paged_decode {tag}: pages take the "
                                 f"{dops.route(q, kp, vp)} route, the slab "
                                 f"{path}")
        by_route = dict(pops.launches_by_route)
        got_p = pops.paged_decode_attention(q, kp, vp, bt, lengths)
        want_p = paged_decode_attention_ref(q, kp, vp, bt, lengths)
        torch.cuda.synchronize()
        if pops.launches_by_route[path] != by_route[path] + 1:
            raise AssertionError(f"paged_decode {tag}: no {path} launch")
        err_p = check_close(got_p, want_p, f"paged_decode {tag}")
        if not torch.equal(got_p, got):
            raise AssertionError(f"paged_decode {tag} differs from "
                                 "decode_attention on the same positions")
        if dtype == bf16:
            check_close(pops.paged_decode_simple_bf16(q, kp, vp, bt, lengths),
                        want_p, f"paged_decode simple {tag}")

            def simple_p(q=q, kp=kp, vp=vp, bt=bt, lengths=lengths):
                return pops.paged_decode_simple_bf16(q, kp, vp, bt, lengths)

        def gather_sdpa(q=q, kp=kp, vp=vp, bt=bt, mask=mask, kvh=kvh, d=d):
            idx = bt.long()
            kg = kp[idx].reshape(b, maxp * PAGE, kvh, d)
            vg = vp[idx].reshape(b, maxp * PAGE, kvh, d)
            return F.scaled_dot_product_attention(
                q[:, :, None], kg.transpose(1, 2), vg.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        gather_ms = cuda_ms(gather_sdpa, flush=flush)
        log(f"[kernel] paged_decode {tag} two-call reference (page gather + "
            f"SDPA, not one library call) {_dt(dtype)}: {gather_ms:.4f} ms")
        pages_read = int(((lengths + PAGE - 1) // PAGE).sum())
        results[("paged_decode", tag, dtype)] = measure(
            "paged_decode",
            f"{tag} B={b} ps={PAGE} MAXP={maxp} H={h}/{kvh} D={d} "
            f"({n_valid} positions attended; equal to decode_attention)",
            dtype, err_p,
            lambda q=q, kp=kp, vp=vp, bt=bt, lengths=lengths:
                pops.paged_decode_attention(q, kp, vp, bt, lengths),
            lambda q=q, kp=kp, vp=vp, bt=bt, lengths=lengths:
                paged_decode_attention_ref(q, kp, vp, bt, lengths), None,
            "none", 4.0 * h * d * n_valid,
            size * (2 * n_valid * kvh * d + 2 * b * h * d)
            + 4 * (pages_read + b), path=path, simple_fn=simple_p)

    # -- decode odd shapes: D = 14, ragged T, null pages, clamped starts ------
    for dtype in (torch.bfloat16, torch.float32):
        b, h, kvh, t, d = 3, 4, 2, 200, 14
        q = rnd((b, h, d), dtype)
        k, v = rnd((b, t, kvh, d), dtype), rnd((b, t, kvh, d), dtype)
        p_ = torch.tensor([150, 37, 199], device="cuda")
        k_pos = torch.arange(t, device="cuda")[None]
        valid = (k_pos <= p_[:, None]) & (k_pos > p_[:, None] - 64)
        err = check_close(dops.decode_attention(q, k, v, valid),
                          decode_attention_ref(q, k, v, valid),
                          "decode_attention odd")
        maxp, n_pages = 13, 1 + 3 * 13
        bt = (torch.randperm(n_pages - 1, generator=torch.Generator()
                             .manual_seed(7)) + 1).reshape(b, maxp)
        bt[1, 3:] = 0                                  # trailing null pages
        bt = bt.to(torch.int32).cuda()
        kp = rnd((n_pages, PAGE, kvh, d), dtype)
        vp = rnd((n_pages, PAGE, kvh, d), dtype)
        lengths = torch.tensor([151, 38, 200], dtype=torch.int32,
                               device="cuda")
        starts = torch.clamp(lengths - 64, min=0).to(torch.int32)
        starts[1] = 0                                  # window start clamped
        err_p = check_close(
            pops.paged_decode_attention(q, kp, vp, bt, lengths, starts),
            paged_decode_attention_ref(q, kp, vp, bt, lengths, starts),
            "paged_decode odd")
        log(f"[kernel] decode odd B=3 T=200 D=14 windowed {_dt(dtype)}: "
            f"decode_attention max_abs_err {err:.3g}, paged_decode (null "
            f"pages, clamped start) max_abs_err {err_p:.3g}")
    del flush
    return results


# =============================================================================
# 6. serve
# =============================================================================

SERVE_REQUESTS, SERVE_TOKENS = 16, 32
# the last 4 requests are priority 2 with a deadline 40 ticks after they
# arrive at these ticks: each becomes deadline-critical while all 8 slots are
# busy and preempts a priority-0 request, which resumes later (paged: from its
# pages).  Running requests are not evicted at their deadline, so every
# request completes.
HI_ARRIVALS, HI_TTL = (10, 18, 26, 34), 40


def serve_specs(vocab: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    lens = rng.integers(17, 701, SERVE_REQUESTS)
    if not (lens >= 512).any():
        lens[0] = 600
    if (lens % PAGE == 0).all():
        lens[0] += 1
    n_lo = SERVE_REQUESTS - len(HI_ARRIVALS)
    specs = []
    for rid, n in enumerate(lens):
        hi = rid >= n_lo
        specs.append(dict(
            rid=rid, prompt=rng.integers(1, vocab, int(n)).tolist(),
            arrival=HI_ARRIVALS[rid - n_lo] if hi else 0,
            priority=2 if hi else 0, ttl=HI_TTL if hi else None))
    return specs


def drive(engine, specs: list[dict]) -> list:
    """Submit each request at its arrival tick and step until all work is
    terminal.  Also returns, per preempted request, the tokens it had when
    it was first preempted, and the tokens every request had just before
    the step in which a preempted request first resumed (None without a
    resume): from that step on, a dense and a paged engine no longer run
    the same arithmetic."""
    from repro_torch.serving import Request
    pending = sorted(specs, key=lambda s: (s["arrival"], s["rid"]))
    reqs, idx = [], 0
    preempted_at = {}           # rid -> tokens it had at its first preemption
    first_resume = None         # rid -> tokens before the first resume step
    while idx < len(pending) or engine._work_pending():
        while idx < len(pending) and pending[idx]["arrival"] <= engine.tick:
            s = pending[idx]
            req = Request(rid=s["rid"], prompt=list(s["prompt"]),
                          max_tokens=SERVE_TOKENS, priority=s["priority"],
                          ttl=s["ttl"])
            engine.submit(req)
            reqs.append(req)
            idx += 1
        before = {r.rid: len(r.output) for r in reqs}
        engine.step()
        for r in reqs:
            if r.preemptions and r.rid not in preempted_at:
                preempted_at[r.rid] = len(r.output)
        if first_resume is None and any(
                r.preemptions and r.state.value != "pending" for r in reqs):
            first_resume = before
    engine.drain()
    return reqs, preempted_at, first_resume


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def serve_both(make_engine, specs: list[dict], dtype,
               modes: tuple[bool, ...] = (False, True)) -> dict:
    """Drive the trace through a dense and (unless ``modes`` leaves it out)
    a paged engine; check that every request completed with no fallback,
    that preemption (and, paged, page resume) happened."""
    runs = {}
    for paged in modes:
        eng = make_engine(paged)
        t0 = time.perf_counter()
        reqs, preempted_at, first_resume = drive(eng, specs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = sum(len(r.output) for r in reqs)
        states = [r.state.value for r in reqs]
        stats = {k: v for k, v in eng.fault_stats.items()
                 if v and k != "by_tenant"}
        label = "paged" if paged else "dense"
        log(f"[serve] {_dt(dtype)} {label}: {eng.tick} ticks, "
            f"{ {s: states.count(s) for s in sorted(set(states))} }, "
            f"{tokens} output tokens in {wall:.3f} s = "
            f"{tokens / wall:.1f} tokens/s; fault_stats {stats}; launches "
            f"recorded in the decode graph "
            f"{eng.decode_graph.recorded_launches}")
        if any(s != "done" for s in states) or len(reqs) != len(specs):
            raise AssertionError(f"{label}: not every request completed")
        for key in ("watchdog_fallbacks", "paged_decode_fallbacks"):
            if eng.fault_stats[key]:
                raise AssertionError(f"{label}: {key} = {eng.fault_stats[key]}")
        if eng.fault_stats["preemptions"] < 1:
            raise AssertionError(f"{label}: no preemption")
        if paged and eng.fault_stats["page_resumes"] < 1:
            raise AssertionError("paged: no page resume")
        runs[label] = ({r.rid: (r.state.value, tuple(r.output))
                        for r in reqs}, preempted_at, first_resume)
        del eng
    return runs


def compare_streams(runs: dict, exact: bool, coupled: bool = False,
                    gated: bool = True) -> None:
    """Paged vs dense: equal terminal states; equal streams for every request
    that was never preempted, and up to its first preemption for one that
    was.  A resumed request continues from retained pages (paged) or from a
    re-prefill of prompt + output (dense), which round differently; with
    ``exact`` its whole stream must agree all the same.  With ``coupled``
    (MoE: a decode token's expert capacity depends on its batchmates, so a
    resumed request that differs can move any batchmate) every stream must
    agree up to the step in which a preempted request first resumed, and
    the streams that differ after it are counted.  Without ``gated`` (the
    two engines run different attention arithmetic) the comparison is
    reported and nothing is held."""
    dense, dense_pre, dense_cut = runs["dense"]
    paged, paged_pre, paged_cut = runs["paged"]
    if gated and (dense_pre != paged_pre or dense_cut != paged_cut):
        raise AssertionError(f"preemptions differ: {dense_pre} {paged_pre}")
    if {r: s for r, (s, _) in dense.items()} != \
            {r: s for r, (s, _) in paged.items()}:
        raise AssertionError("paged and dense terminal states differ")
    diverged = []
    for rid, (_, want) in sorted(dense.items()):
        got = paged[rid][1]
        if got == want:
            continue
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                     min(len(got), len(want)))
        diverged.append((rid, first, len(want), dense_pre.get(rid)))
        if coupled:
            held = None if dense_cut is None else dense_cut[rid]
        else:
            held = dense_pre.get(rid)
        if gated and (held is None or first < held):
            raise AssertionError(
                f"rid {rid}: paged and dense streams differ at token {first} "
                f"(held equal up to {held})")
    n_tok = sum(len(o) for _, o in dense.values())
    log(f"[serve] paged vs dense ({'exact' if exact else 'up to a resume'}"
        f"{', coupled batch' if coupled else ''}"
        f"{'' if gated else ', reported only'}): terminal states equal; "
        f"{len(dense) - len(diverged)}/{len(dense)} streams equal ({n_tok} "
        f"tokens); preempted requests (rid: tokens before the first "
        f"preemption) {dense_pre}; streams that diverge after a resume (rid, "
        f"first differing token, length, preempted at) {diverged}")
    if gated and exact and diverged:
        raise AssertionError("paged and dense token streams differ")


def _agreement(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    got, want = got.float(), want.float()
    rel = float((got - want).norm() / want.norm())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return rel, agree


def _check_agreement(what: str, got, want, failures: list,
                     gate_top1: bool = True) -> None:
    """Log the agreement; a miss is added to ``failures``, which the phase
    raises at its end (so one run reports every comparison).  Top-1 is
    gated only where rounding noise stays below the greedy margins (fp32):
    in bf16 a random-weight 24-layer model carries any rounding difference
    to about 1.5e-2 of the logits, the plain route's own distance from
    fp32 (the diagnostics below), which flips a few percent of tokens."""
    rel, agree = _agreement(got, want)
    gate = f">= {TOP1_AGREE}" if gate_top1 else "reported"
    log(f"[serve] {what}: rel_l2 {rel:.3e} (<= {LOGITS_REL_L2}) top1 "
        f"agreement {agree:.4f} ({gate})")
    if not (rel <= LOGITS_REL_L2 and (agree >= TOP1_AGREE or not gate_top1)):
        failures.append(f"{what}: kernel route disagrees with the plain "
                        f"route (rel_l2 {rel:.3e}, top1 {agree:.4f})")


def _counters(*names: str) -> dict:
    """(wrapper module, name of its launch count) by kernel."""
    from repro_torch.kernels.branch_gemm import ops as bops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.grouped_gemm import ops as gops
    from repro_torch.kernels.moe_gemm import ops as mops
    from repro_torch.kernels.paged_decode import ops as pops
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rwkv6 import ops as wops
    counters = {"branch_gemm": (bops, "launches"),
                "grouped_gemm": (gops, "launches"),
                "rmsnorm": (rops, "launches"),
                "flash_attention": (fops, "launches"),
                "decode_attention": (dops, "launches"),
                "paged_decode": (pops, "launches"),
                "paged_decode_mla": (pops, "mla_launches"),
                "moe_gemm": (mops, "launches"), "rwkv6": (wops, "launches")}
    return {name: counters[name] for name in names}


def reset_launches() -> None:
    from repro_torch.kernels.branch_gemm import ops as bops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.grouped_gemm import ops as gops
    from repro_torch.kernels.moe_gemm import ops as mops
    from repro_torch.kernels.paged_decode import ops as pops
    from repro_torch.kernels.rmsnorm import ops as rops
    for module, attr in _counters(*KERNELS).values():
        setattr(module, attr, 0)
    from repro_torch.kernels.rwkv6 import ops as wops
    for module in (bops, gops, fops, dops, mops, rops, wops):
        module.launches_by_route.update(dict.fromkeys(module.ROUTES, 0))
    pops.launches_by_route.update(dict.fromkeys(dops.ROUTES, 0))
    pops.mla_launches_by_route.update(dict.fromkeys(pops.MLA_ROUTES, 0))


def gemm_routes() -> dict:
    """branch_gemm's and grouped_gemm's launches by route since the last
    reset_launches()."""
    from repro_torch.kernels.branch_gemm import ops as bops
    from repro_torch.kernels.grouped_gemm import ops as gops
    return {"branch_gemm": dict(bops.launches_by_route),
            "grouped_gemm": dict(gops.launches_by_route)}


def check_wgmma_only(tag: str, routes: dict) -> None:
    """An op-graph path's GEMM launches all took the wgmma route."""
    off = {name: {r: n for r, n in by.items() if r != "wgmma" and n}
           for name, by in routes.items()}
    if any(off.values()):
        raise AssertionError(f"[{tag}] GEMM launches off the wgmma route: "
                             f"{routes}")
    if not any(by["wgmma"] for by in routes.values()):
        raise AssertionError(f"[{tag}] no wgmma GEMM launch: {routes}")


def check_flash_wgmma_only(tag: str) -> None:
    """A bf16 serving run's flash_attention launches since the last
    reset_launches() all took the wgmma route."""
    from repro_torch.kernels.flash_attention import ops as fops
    routes = dict(fops.launches_by_route)
    log(f"[{tag}] flash_attention launches over the bf16 serving runs, by "
        f"route {routes}")
    if any(n for r, n in routes.items() if r != "wgmma") or \
            not routes["wgmma"]:
        raise AssertionError(f"[{tag}] bf16 prefills launched flash_attention "
                             f"off the wgmma route: {routes}")


def check_decode_mma_only(tag: str) -> None:
    """A bf16 serving run's decode_attention and paged_decode launches since
    the last reset_launches() all took the mma route."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.paged_decode import ops as pops
    routes = {"decode_attention": dict(dops.launches_by_route),
              "paged_decode": dict(pops.launches_by_route)}
    log(f"[{tag}] decode launches over the bf16 serving runs, by route "
        f"{routes}")
    if any(n for by in routes.values() for r, n in by.items() if r != "mma") \
            or not all(by["mma"] for by in routes.values()):
        raise AssertionError(f"[{tag}] bf16 decode ticks launched the decode "
                             f"pair off the mma route: {routes}")


def check_moe_wgmma_only(tag: str) -> None:
    """A bf16 serving run's moe_gemm launches since the last
    reset_launches() all took the wgmma route."""
    from repro_torch.kernels.moe_gemm import ops as mops
    routes = dict(mops.launches_by_route)
    log(f"[{tag}] moe_gemm launches over the bf16 serving runs, by route "
        f"{routes}")
    if any(n for r, n in routes.items() if r != "wgmma") or \
            not routes["wgmma"]:
        raise AssertionError(f"[{tag}] bf16 serving launched moe_gemm off "
                             f"the wgmma route: {routes}")


def check_rwkv_chunked_only(tag: str) -> None:
    """A run's rwkv6 launches since the last reset_launches() (an op-graph
    forward at 512 positions, or a prefill of at least CHUNKED_MIN_T
    tokens) all took the chunked route."""
    from repro_torch.kernels.rwkv6 import ops as wops
    routes = dict(wops.launches_by_route)
    log(f"[{tag}] rwkv6 launches by route {routes}")
    if any(n for r, n in routes.items() if r != "chunked") or \
            not routes["chunked"]:
        raise AssertionError(f"[{tag}] rwkv6 launched off the chunked "
                             f"route: {routes}")


def check_mla_wgmma_only(tag: str) -> None:
    """A bf16 serving run's MLA paged-decode launches since the last
    reset_launches() all took the wgmma route."""
    from repro_torch.kernels.paged_decode import ops as pops
    routes = dict(pops.mla_launches_by_route)
    log(f"[{tag}] MLA paged-decode launches over the bf16 serving runs, by "
        f"route {routes}")
    if any(n for r, n in routes.items() if r != "wgmma") or \
            not routes["wgmma"]:
        raise AssertionError(f"[{tag}] bf16 serving launched the MLA decode "
                             f"off the wgmma route: {routes}")


def read_launches(*names: str) -> dict:
    return {name: getattr(module, attr)
            for name, (module, attr) in _counters(*names).items()}


def phase_serve(seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.transformer import lm_forward
    from repro_torch.serving import AdmissionConfig, InferenceEngine

    cfg = get_config("qwen2-0.5b")
    model = Model(cfg, use_kernels=True)
    plain = Model(cfg, use_kernels=False)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        "cuda")
    torch.cuda.synchronize()
    specs = serve_specs(cfg.vocab_size, seed)
    lens = [len(s["prompt"]) for s in specs]
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} {_dt(cfg.dtype)}, init "
        f"{time.perf_counter() - t0:.2f} s; {len(specs)} requests, prompt "
        f"lengths {lens}, {SERVE_TOKENS} greedy tokens each")

    def engine(paged: bool):
        return InferenceEngine(
            model, params, max_slots=SLOTS, max_len=MAX_LEN, seed=seed,
            admission=AdmissionConfig(policy="edf", preemption=True,
                                      expire_running=False),
            paged_kv=paged, page_size=PAGE,
            num_pages=1 + 2 * SLOTS * (MAX_LEN // PAGE) if paged else None)

    # -- the main path's run: launch counts from 0 ----------------------------
    reset_launches()
    runs = serve_both(engine, specs, cfg.dtype)
    launches = read_launches("rmsnorm", "flash_attention",
                             "decode_attention", "paged_decode")
    check_flash_wgmma_only("serve")
    check_decode_mma_only("serve")
    # -- end of the main path's run ------------------------------------------
    log(f"[serve] wrapper launches over both runs (eager prefills + graph "
        f"warm-up and recording) {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the serve path launched no {name}")
    compare_streams(runs, exact=False)
    del runs
    # the same trace in fp32 (weights upcast): arithmetic noise far below
    # the greedy margins, so even the resumed requests' streams must agree
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = _cast(params, torch.float32)
    runs = serve_both(lambda paged: InferenceEngine(
        Model(cfg32, use_kernels=True), params32, max_slots=SLOTS,
        max_len=MAX_LEN, seed=seed,
        admission=AdmissionConfig(policy="edf", preemption=True,
                                  expire_running=False),
        paged_kv=paged, page_size=PAGE,
        num_pages=1 + 2 * SLOTS * (MAX_LEN // PAGE) if paged else None),
        specs, torch.float32)
    compare_streams(runs, exact=True)
    del runs

    # -- the kernel route against the plain route on the card ----------------
    failures: list[str] = []
    by_len = sorted(specs, key=lambda s: len(s["prompt"]))
    prompts = [by_len[0], by_len[len(by_len) // 2], by_len[-1]]
    for c, p_, fp32 in ((cfg, params, False), (cfg32, params32, True)):
        for s in prompts:
            tokens = torch.tensor([s["prompt"]], device="cuda")
            got, _ = lm_forward(p_, tokens, c, True, with_cache=False)
            want, _ = lm_forward(p_, tokens, c, False, with_cache=False)
            if not bool(torch.isfinite(got).all()) or \
                    got.shape != (1, tokens.shape[1], c.vocab_size):
                raise AssertionError(f"bad logits {tuple(got.shape)}")
            _check_agreement(f"{_dt(c.dtype)} lm_forward logits, all "
                             f"{tokens.shape[1]} positions", got, want,
                             failures, gate_top1=fp32)
            del got, want
    # diagnostics (reported, not gated): both bf16 routes against the fp32
    # plain route, and the plain route with only its probabilities in fp32
    tokens = torch.tensor([prompts[1]["prompt"]], device="cuda")
    truth, _ = lm_forward(params32, tokens, cfg32, False, with_cache=False)
    for route, name in ((False, "plain"), (True, "kernel")):
        got, _ = lm_forward(params, tokens, cfg, route, with_cache=False)
        rel, agree = _agreement(got, truth)
        log(f"[serve] diagnostic: bf16 {name} route vs fp32 plain route, "
            f"{tokens.shape[1]} positions: rel_l2 {rel:.3e} top1 agreement "
            f"{agree:.4f}")
    del truth, got
    rounding_point(cfg, params, prompts[1]["prompt"])
    teacher_forced(cfg, model, plain, params, specs[:SLOTS], seed, failures,
                   gate_top1=False)
    teacher_forced(cfg32, Model(cfg32, use_kernels=True),
                   Model(cfg32, use_kernels=False), params32, specs[:SLOTS],
                   seed, failures, gate_top1=True)
    del params32

    # -- one decode tick: graph vs eager, times, profile ---------------------
    timings = {}
    for paged in (False, True):
        eng = engine(paged)
        from repro_torch.serving import Request
        for s in specs[:SLOTS]:
            eng.submit(Request(rid=s["rid"], prompt=list(s["prompt"]),
                               max_tokens=SERVE_TOKENS))
        for _ in range(SLOTS + 1):          # 8 prefills, then a decode tick
            eng.step()
        if sum(r is not None for r in eng.slots) != SLOTS:
            raise AssertionError("not all slots active")
        values = [eng.last_token, eng.pos]
        if paged:
            values.append(eng._block_table_array())
            bt = eng._on_device(values[2], torch.int32)

            def eager():
                return eng.model.paged_decode(
                    eng.params, eng._on_device(eng.last_token, torch.long),
                    eng.caches, bt, eng._on_device(eng.pos, torch.int32))[0]
        else:
            eager = eng._eager_decode
        graph_logits = eng._step(values).clone()
        eager_logits = eager()
        label = "paged" if paged else "dense"
        if not torch.equal(graph_logits, eager_logits):
            raise AssertionError(f"{label}: CUDA-graph decode tick differs "
                                 "from the eager tick")
        graph_ms = cuda_ms(lambda: eng._step(values))
        eager_ms = cuda_ms(eager)
        log(f"[serve] {label} decode tick at {SLOTS} active slots "
            f"(median of {TIMING_ITERS}): CUDA-graph replay {graph_ms:.3f} ms "
            f"(host copies of token/pos/table included), eager "
            f"{eager_ms:.3f} ms; graph logits bit-equal to eager")
        timings[label] = (graph_ms, eager_ms)
        profile_replay(lambda: eng._step(values), n=5,
                       what=f"{label} decode tick (graph)", tag="profile")
        del eng
    for s in (by_len[0], by_len[len(by_len) // 2], by_len[-1]):
        tokens = torch.tensor([s["prompt"]], device="cuda")
        ms = cuda_ms(lambda: model.prefill(params, {"tokens": tokens},
                                           cache_len=MAX_LEN), iters=10)
        log(f"[serve] prefill {tokens.shape[1]} tokens (batch 1, eager, "
            f"kernel route, median of 10): {ms:.3f} ms")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches}


def _sdpa_fp32_probs(q, k, v, mask, scale=None):
    """The model's plain attention with the probabilities kept in fp32 (the
    JAX flash reference's numerics; an online softmax that rounds the
    unnormalised probabilities moves the rounding as far)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, s, kvh, h // kvh, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    m = mask if mask.dim() == 2 else mask[:, None, None]
    p = torch.softmax(torch.where(m, logits, -1e30), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def rounding_point(cfg, params, prompt: list[int]) -> None:
    """Diagnostic (reported, not gated): how far the plain route moves when
    only the rounding point of the softmax probabilities changes."""
    from repro_torch.models import attention
    from repro_torch.models.transformer import lm_forward
    tokens = torch.tensor([prompt], device="cuda")
    want, _ = lm_forward(params, tokens, cfg, False, with_cache=False)
    plain_sdpa = attention._sdpa
    attention._sdpa = _sdpa_fp32_probs
    try:
        got, _ = lm_forward(params, tokens, cfg, False, with_cache=False)
    finally:
        attention._sdpa = plain_sdpa
    rel, agree = _agreement(got, want)
    log(f"[serve] diagnostic: plain route with fp32 softmax probabilities vs "
        f"the plain route (bf16 probabilities), {tokens.shape[1]} positions: "
        f"rel_l2 {rel:.3e} top1 agreement {agree:.4f}")


def teacher_forced(cfg, model, plain, params, specs, seed: int,
                   failures: list, gate_top1: bool, paged: bool = True,
                   steps: int = SERVE_TOKENS,
                   paged_is_dense: bool = True) -> None:
    """``steps`` decode steps at 8 slots on the same forced tokens: the
    kernel route (dense slab and, with ``paged``, paged) against the plain
    route (dense slab); with ``paged_is_dense`` (one decode routine for
    both, as GQA's) paged must equal dense on the kernel route, step for
    step."""
    from repro_torch.models.transformer import (init_decode_caches,
                                                init_paged_decode_caches)
    from repro_torch.serving.engine import _leaves
    maxp = MAX_LEN // PAGE
    lens = torch.tensor([len(s["prompt"]) for s in specs], device="cuda")
    forced = torch.randint(1, cfg.vocab_size, (steps, SLOTS),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(seed + 1), device="cuda")
    bt = (torch.randperm(SLOTS * maxp, generator=torch.Generator()
                         .manual_seed(seed)) + 1).reshape(SLOTS, maxp)
    bt = bt.to(torch.int32).cuda()

    def prefilled(m):
        caches = init_decode_caches(cfg, SLOTS, MAX_LEN, device="cuda")
        for i, s in enumerate(specs):
            tokens = torch.tensor([s["prompt"]], device="cuda")
            _, cache = m.prefill(params, {"tokens": tokens}, cache_len=MAX_LEN)
            for big, small in zip(_leaves(caches), _leaves(cache)):
                big[:, i].copy_(small[:, 0])
        return caches

    kernel_dense = prefilled(model)
    plain_dense = prefilled(plain)
    if paged:
        pages = init_paged_decode_caches(cfg, 1 + SLOTS * maxp, PAGE,
                                         device="cuda")
        for (pk, pv), (k, v) in zip(pages, kernel_dense):
            L = k.shape[0]
            pk[:, bt.long().flatten()] = k.reshape(L, SLOTS * maxp, PAGE,
                                                   *k.shape[3:])
            pv[:, bt.long().flatten()] = v.reshape(L, SLOTS * maxp, PAGE,
                                                   *v.shape[3:])
    got_d, got_p, want = [], [], []
    for t in range(steps):
        pos = (lens + t).to(torch.int32)
        got_d.append(model.decode(params, forced[t], kernel_dense, pos)[0])
        want.append(plain.decode(params, forced[t], plain_dense, pos)[0])
        if paged:
            got_p.append(model.paged_decode(params, forced[t], pages, bt,
                                            pos)[0])
            if paged_is_dense and not torch.equal(got_p[-1], got_d[-1]):
                raise AssertionError(f"step {t}: paged decode logits differ "
                                     "from dense on the kernel route")
    what = (f"{cfg.name} {_dt(cfg.dtype)} {steps} teacher-forced decode "
            f"steps x {SLOTS} slots")
    _check_agreement(f"{what}, dense slab", torch.stack(got_d),
                     torch.stack(want), failures, gate_top1)
    if paged:
        _check_agreement(f"{what}, paged", torch.stack(got_p),
                         torch.stack(want), failures, gate_top1)
        if paged_is_dense:
            log("[serve] teacher-forced paged logits bit-equal to dense at "
                "every step")


# =============================================================================
# 7. moe_gemm and rwkv6 kernels, and the all-masked decode row
# =============================================================================

# Kimi-K2's expert geometry and RWKV6-1.6B's heads
KIMI_E, KIMI_D, KIMI_F = 384, 7168, 2048
RWKV_H, RWKV_K = 32, 64


def _expert_stack(gen, shape, scale, dtype):
    """Random expert weights drawn one matrix at a time (a bf16 stack of
    Kimi-K2 is 11.3 GB; its fp32 draw would be twice that)."""
    out = torch.empty(shape, dtype=dtype, device="cuda")
    for i in range(shape[0]):
        out[i] = (torch.randn(shape[1:], generator=gen, device="cuda")
                  * scale).to(dtype)
    return out


def _moe_chain(buf, gate, up, down):
    """The bmm/silu chain of PyTorch calls for the same function (cuBLAS
    bmm, which rounds h's two factors to the dtype): the nearest thing to
    a library call, since no single one computes the expert MLP."""
    F = torch.nn.functional
    return torch.bmm(F.silu(torch.bmm(buf, gate)) * torch.bmm(buf, up), down)


def phase_moe_rwkv_kernels(env: dict, gen: torch.Generator) -> dict:
    from repro_torch.kernels.moe_gemm import ops as mops
    from repro_torch.kernels.moe_gemm.ref import moe_mlp_ref
    from repro_torch.kernels.rwkv6 import ops as wops
    from repro_torch.kernels.rwkv6.ref import rwkv6_ref

    hw = env["hw"]
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    results = {}

    def peak(dtype):
        return hw.peak_flops if dtype == torch.bfloat16 else FP32_PEAK[hw.name]

    # -- moe_gemm at Kimi-K2's full width: a decode tick's real occupancy (8
    # tokens' top-8 over the 384 experts at C = 1, every other expert's row
    # zero), every expert full at C = 1 and at a 512-token prefill's C = 13,
    # each beside the simple route (the routine the wgmma route replaced) in
    # the same call; every expert empty; only the last expert with a row;
    # fp32 at 16 experts, some empty; off the TMA rule (the simple route)
    full = [_expert_stack(gen, (KIMI_E, KIMI_D, KIMI_F), KIMI_D ** -0.5,
                          torch.bfloat16),
            _expert_stack(gen, (KIMI_E, KIMI_D, KIMI_F), KIMI_D ** -0.5,
                          torch.bfloat16),
            _expert_stack(gen, (KIMI_E, KIMI_F, KIMI_D), KIMI_F ** -0.5,
                          torch.bfloat16)]
    picks = torch.rand((SLOTS, KIMI_E), generator=gen, device="cuda").topk(
        8, dim=-1).indices
    tick_experts = torch.unique(picks)
    for tag, (e, c, d, f), dtype, rows, timed in [
            ("tick C=1", (KIMI_E, 1, KIMI_D, KIMI_F), torch.bfloat16,
             tick_experts, True),
            ("full C=1", (KIMI_E, 1, KIMI_D, KIMI_F), torch.bfloat16, None,
             True),
            ("full C=13", (KIMI_E, 13, KIMI_D, KIMI_F), torch.bfloat16, None,
             True),
            ("all empty C=1", (KIMI_E, 1, KIMI_D, KIMI_F), torch.bfloat16,
             tick_experts[:0], False),
            ("last expert, one row, C=13", (KIMI_E, 13, KIMI_D, KIMI_F),
             torch.bfloat16, torch.tensor([KIMI_E - 1], device="cuda"), False),
            ("fp32 E=16 C=13, 11 empty", (16, 13, KIMI_D, KIMI_F),
             torch.float32, torch.tensor([0, 3, 7, 12, 15], device="cuda"),
             False),
            ("odd C=5 d=200 f=136", (3, 5, 200, 136), torch.bfloat16, None,
             False),
            ("odd C=5 d=200 f=136", (3, 5, 200, 136), torch.float32, None,
             False)]:
        if e == KIMI_E:
            gate, up, down = full
        else:
            gate, up, down = (_expert_stack(gen, (e, d, f), d ** -0.5, dtype),
                              _expert_stack(gen, (e, d, f), d ** -0.5, dtype),
                              _expert_stack(gen, (e, f, d), f ** -0.5, dtype))
        buf = torch.randn((e, c, d), generator=gen, device="cuda").to(dtype)
        active = e
        if rows is not None:
            # the capacity rows the dispatch fills: row 0 of the routed
            # experts (C = 1), or the last row of the one expert
            keep = torch.zeros((e, c, 1), dtype=dtype, device="cuda")
            keep[rows, c - 1 if len(rows) == 1 else 0] = 1
            buf = buf * keep
            active = len(rows)
        path = mops.route(buf, gate, up, down)
        before = dict(mops.launches_by_route)
        got = mops.moe_mlp(buf, gate, up, down)
        want = moe_mlp_ref(buf, gate, up, down)
        torch.cuda.synchronize()
        err = check_close(got, want, f"moe_gemm {tag}")
        if {r: n - before[r] for r, n in mops.launches_by_route.items()
                if n != before[r]} != {path: 1}:
            raise AssertionError(f"moe_gemm {tag} did not count one {path} "
                                 f"launch")
        if path != {torch.float32: "fp32"}.get(
                dtype, "wgmma" if d % 8 == 0 and f % 8 == 0 else "simple"):
            raise AssertionError(f"moe_gemm {tag} took the {path} route")
        empty = (buf == 0).flatten(1).all(dim=1)
        zero_rows = got[empty]
        if bool((zero_rows != 0).any()) or bool(
                torch.signbit(zero_rows).any()):
            raise AssertionError(f"moe_gemm {tag}: an empty expert's rows "
                                 f"are not +0")
        if not timed:
            log(f"[kernel] moe_gemm {tag} [{e},{c},{d}] f={f} {_dt(dtype)}: "
                f"route {path}, {active} of {e} experts with a row, "
                f"max_abs_err {err:.3g}, empty experts' rows +0")
            continue
        size = buf.element_size()
        # the function reads every row of buf (to find the empty experts),
        # the active experts' weights, and writes every row of out
        n_flops = 2.0 * 3 * active * c * d * f
        n_bytes = size * (3 * active * d * f + 2 * e * c * d)
        bound, by = gemm_bound_ms(n_flops, n_bytes, peak(dtype), hw.hbm_bw)
        kernel_ms = cuda_ms(lambda: mops.moe_mlp(buf, gate, up, down),
                            flush=flush)
        simple_ms = cuda_ms(
            lambda: mops.moe_mlp_simple_bf16(buf, gate, up, down),
            flush=flush)
        plain_ms = cuda_ms(lambda: moe_mlp_ref(buf, gate, up, down),
                           flush=flush)
        chain_ms = cuda_ms(lambda: _moe_chain(buf, gate, up, down),
                           flush=flush)
        log(f"[kernel] moe_gemm {tag} [{e},{c},{d}] f={f} {_dt(dtype)}: "
            f"route {path}, {active} of {e} experts with a row: max_abs_err "
            f"{err:.3g} kernel_ms {kernel_ms:.4f} ({bound / kernel_ms:.3f} of "
            f"the bound) simple_ms {simple_ms:.4f} "
            f"({simple_ms / kernel_ms:.2f}x) plain_ms {plain_ms:.4f} library "
            f"none (bmm/silu/bmm/bmm chain of four calls: {chain_ms:.4f} ms) "
            f"bound_us {bound * 1e3:.2f} ({by}; {n_flops / 1e9:.2f} GFLOP, "
            f"{n_bytes / 1e9:.3f} GB)")
        results[("moe_gemm", tag)] = dict(
            max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None, chain_ms=chain_ms,
            simple_ms=simple_ms)
        del buf, got, want
    del full, gate, up, down
    free_card()

    # -- rwkv6: a 512-token prefill, a decode tick of 8 slots, odd T, the
    # model layout; the route each takes, and the step route (the routine
    # the chunked route replaced) in the same call ---------------------------
    h, k = RWKV_H, RWKV_K

    def wkv_operands(b, t, decays):
        r, kk, v = (torch.randn((b, h, t, k), generator=gen, device="cuda")
                    for _ in range(3))
        if decays == "strong":
            # uniform over (0, 1) with a sixth exact zeros and a sixth
            # 1 - 1e-7 (trained checkpoints' fast and slow channels)
            w = torch.rand((b, h, t, k), generator=gen, device="cuda")
            pick = torch.rand((b, h, t, k), generator=gen, device="cuda")
            w = torch.where(pick < 1 / 6, torch.zeros_like(w), w)
            w = torch.where(pick > 5 / 6, torch.full_like(w, 1 - 1e-7), w)
        else:   # the random-init model's decays, w_base = -6
            w = torch.exp(-torch.exp(torch.randn(
                (b, h, t, k), generator=gen, device="cuda") * 0.5 - 6.0))
        u = torch.randn((h, k), generator=gen, device="cuda") * 0.1
        s0 = torch.randn((b, h, k, k), generator=gen, device="cuda")
        return r, kk, v, w, u, s0

    for tag, (b, t), decays, layout, timed in [
            ("prefill T=512", (1, 512), "model", "kernel", True),
            ("decode B=8 T=1", (8, 1), "model", "kernel", True),
            ("strong decays T=512", (1, 512), "strong", "kernel", False),
            ("strong decays T=700", (1, 700), "strong", "kernel", False),
            ("odd T=17", (1, 17), "model", "kernel", False),
            ("T=700", (1, 700), "model", "kernel", False),
            ("model layout T=700", (1, 700), "model", "model", False)]:
        args = wkv_operands(b, t, decays)
        r, kk, v, w, u, s0 = args
        before = dict(wops.launches_by_route)
        if layout == "model":
            # [B,T,H,K] columns of one wider projection, as the model's
            # r, k, v, w views: read in place, y written in that layout
            wide = torch.stack([x.transpose(1, 2) for x in args[:4]], dim=2)
            out_m, s_final = wops.rwkv6_model(*wide.unbind(2), u, s0)
            if not out_m.is_contiguous():
                raise AssertionError("rwkv6_model did not write [B,T,H,K] "
                                     "contiguous")
            out = out_m.transpose(1, 2)
        else:
            out, s_final = wops.rwkv6(*args)
        path = {rt: n - before[rt] for rt, n in
                wops.launches_by_route.items() if n != before[rt]}
        want_out, want_s = rwkv6_ref(*args)
        step_out, step_s = wops.rwkv6_step(*args)
        torch.cuda.synchronize()
        err = max(check_close(out, want_out, f"rwkv6 {tag} out"),
                  check_close(s_final, want_s, f"rwkv6 {tag} state"))
        step_err = max(check_close(step_out, want_out, f"rwkv6 step {tag}"),
                       check_close(step_s, want_s, f"rwkv6 step {tag} state"))
        if not all(bool(torch.isfinite(x).all()) for x in (out, s_final)):
            raise AssertionError(f"rwkv6 {tag}: NaN or inf")
        want_route = "chunked" if t >= wops.CHUNKED_MIN_T else "step"
        if path != {want_route: 1}:
            raise AssertionError(f"rwkv6 {tag}: launches {path}, want one "
                                 f"{want_route}")
        if not timed:
            log(f"[kernel] rwkv6 {tag} B={b} H={h} K={k} ({decays} decays, "
                f"{layout} layout, nonzero s0): route {want_route} "
                f"max_abs_err {err:.3g} (step route {step_err:.3g})")
            continue
        n_flops = 6.0 * b * h * t * k * k
        n_bytes = 4 * (5 * b * h * t * k + 2 * b * h * k * k + h * k)
        bound, by = gemm_bound_ms(n_flops, n_bytes, FP32_PEAK[hw.name],
                                  hw.hbm_bw)
        kernel_ms = cuda_ms(lambda: wops.rwkv6(*args), flush=flush)
        step_ms = cuda_ms(lambda: wops.rwkv6_step(*args), flush=flush)
        plain_ms = cuda_ms(lambda: rwkv6_ref(*args), flush=flush, iters=5)
        log(f"[kernel] rwkv6 {tag} B={b} H={h} K={k} fp32: route "
            f"{want_route} max_abs_err {err:.3g} kernel_ms {kernel_ms:.4f} "
            f"({bound / kernel_ms:.3f} of the bound) step_ms {step_ms:.4f} "
            f"({step_ms / kernel_ms:.2f}x) plain_ms {plain_ms:.4f} library "
            f"none bound_us {bound * 1e3:.3f} ({by}; {n_flops / 1e6:.2f} "
            f"MFLOP, {n_bytes / 1e6:.3f} MB)")
        results[("rwkv6", tag)] = dict(
            max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None, step_ms=step_ms)
    # where the route rule switches: both routes around CHUNKED_MIN_T
    from repro_torch.kernels.rwkv6.kernel import rwkv6_cuda
    crossover = []
    for t in (32, 48, 64):
        args = wkv_operands(1, t, "model")
        out, s_final = torch.empty_like(args[0]), torch.empty_like(args[5])
        ms = {route: cuda_ms(lambda route=route: rwkv6_cuda(
            *args, out, s_final, route), flush=flush)
            for route in ("chunked", "step")}
        crossover.append(f"T={t} chunked {ms['chunked']:.4f} step "
                         f"{ms['step']:.4f}")
    log(f"[kernel] rwkv6 B=1 H={h} K={k} routes around CHUNKED_MIN_T="
        f"{wops.CHUNKED_MIN_T} (ms): {'; '.join(crossover)}")
    del flush
    return results


def phase_masked_row(gen: torch.Generator) -> None:
    """A decode row with no attended position: both kernels give their
    plain versions' (and the JAX package's) answer, V averaged over every
    position of the row — null pages included when paged."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.paged_decode import ops as pops
    from repro_torch.kernels.paged_decode.ref import paged_decode_attention_ref
    for dtype in (torch.bfloat16, torch.float32):
        b, t, h, kvh, d = SLOTS, MAX_LEN, HEADS, KV_HEADS, HEAD_DIM
        q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, t, kvh, d), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        valid = torch.arange(t, device="cuda")[None] < torch.tensor(
            [0, 300] * (b // 2), device="cuda")[:, None]
        got = dops.decode_attention(q, k, v, valid)
        want = decode_attention_ref(q, k, v, valid)
        torch.cuda.synchronize()
        err = check_close(got, want, "decode_attention all-masked rows")
        mean = v[0].float().mean(0).repeat_interleave(h // kvh, dim=0)
        err_mean = float((got[0].float() - mean).abs().max())
        maxp = 12
        n_pages = 1 + b * maxp
        bt = (torch.randperm(n_pages - 1, generator=torch.Generator()
                             .manual_seed(3)) + 1).reshape(b, maxp)
        bt[0, 5:] = 0                                  # null pages
        bt = bt.to(torch.int32).cuda()
        kp, vp = (torch.randn((n_pages, PAGE, kvh, d), generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        lengths = torch.tensor([0, 150] * (b // 2), dtype=torch.int32,
                               device="cuda")
        got_p = pops.paged_decode_attention(q, kp, vp, bt, lengths)
        want_p = paged_decode_attention_ref(q, kp, vp, bt, lengths)
        torch.cuda.synchronize()
        err_p = check_close(got_p, want_p, "paged_decode all-masked rows")
        log(f"[kernel] all-masked decode rows {_dt(dtype)}: decode_attention "
            f"max_abs_err vs plain {err:.3g} (vs the mean of V over T={t}: "
            f"{err_mean:.3g}), paged_decode (null pages in the table) "
            f"{err_p:.3g}")


# =============================================================================
# 8. Kimi-K2: op graph and serving at full width, 2 layers
# =============================================================================

def _kept_choice(top_idx: torch.Tensor, moe) -> list[tuple]:
    """Per token, (routed experts, experts that kept it) of one MoE call:
    the sort dispatch's within-expert rank by token order, against the
    call's capacity."""
    from repro_torch.models.ffn import _capacity
    idx = top_idx.cpu().numpy()
    n, k = idx.shape
    cap = _capacity(n, moe)
    seen: dict[int, int] = {}
    out = []
    for row in idx:
        kept = []
        for ex in row.tolist():
            rank = seen.get(ex, 0)
            seen[ex] = rank + 1
            if rank < cap:
                kept.append(ex)
        out.append((tuple(sorted(row.tolist())), tuple(sorted(kept))))
    return out


class RouteRecorder:
    """Records every routing decision of the port's MoE layer (the expert
    ids of each call) while active."""

    def __enter__(self):
        from repro_torch.models import ffn
        self.calls = []
        self._ffn, self._route = ffn, ffn.route

        def recording(p, x, e, generator=None):
            out = self._route(p, x, e, generator)
            self.calls.append((out[1].clone(), e))
            return out
        ffn.route = recording
        return self

    def __exit__(self, *exc):
        self._ffn.route = self._route


def _agreeing_positions(a: RouteRecorder, b: RouteRecorder):
    """Per token of two runs of the same input: whether its routed experts
    agree in every MoE call, and whether the experts that kept it (after
    capacity) agree too — a flip ahead of a token in an expert's order can
    move the capacity cut past it."""
    if len(a.calls) != len(b.calls):
        raise AssertionError("the two routes made different MoE calls")
    routed = kept = None
    for (ia, e), (ib, _) in zip(a.calls, b.calls):
        ca, cb = _kept_choice(ia, e), _kept_choice(ib, e)
        r = torch.tensor([x[0] == y[0] for x, y in zip(ca, cb)])
        k = torch.tensor([x == y for x, y in zip(ca, cb)])
        routed = r if routed is None else routed & r
        kept = k if kept is None else kept & k
    return routed, kept


def kimi_forward_gate(what: str, cfg, params, prompts, failures: list,
                      gate_top1: bool, tag: str = "kimi") -> None:
    """Kernel route vs plain route, whole model, on each prompt.  In bf16
    the logits gate covers the positions whose expert choice (and capacity
    outcome) agrees in both routes — a bf16 ulp upstream of the router can
    swap a token's 8th and 9th experts — and the share of positions whose
    expert choice flips is held to 10%; with ``gate_top1`` (fp32) every
    position is gated."""
    from repro_torch.models.transformer import lm_forward
    for s in prompts:
        tokens = torch.tensor([s["prompt"]], device="cuda")
        with RouteRecorder() as kr:
            got, _ = lm_forward(params, tokens, cfg, True, with_cache=False)
        with RouteRecorder() as pr:
            want, _ = lm_forward(params, tokens, cfg, False, with_cache=False)
        if not bool(torch.isfinite(got).all()) or \
                got.shape != (1, tokens.shape[1], cfg.vocab_size):
            raise AssertionError(f"bad logits {tuple(got.shape)}")
        routed, kept = _agreeing_positions(kr, pr)
        flips = 1.0 - float(routed.float().mean())
        moved = float((routed & ~kept).float().mean())
        log(f"[{tag}] {what}, {tokens.shape[1]} positions: expert choice "
            f"flips at {flips:.4f} of them (<= 0.10); capacity outcome moved "
            f"by another token's flip at {moved:.4f}")
        if flips > 0.10:
            failures.append(f"{what}: expert flips at {flips:.4f}")
        if gate_top1:
            _check_agreement(f"{what} lm_forward logits, all positions",
                             got, want, failures, gate_top1=True)
        else:
            agree = kept.to("cuda")
            _check_agreement(f"{what} lm_forward logits, the "
                             f"{int(agree.sum())} positions whose experts "
                             f"agree", got[:, agree], want[:, agree],
                             failures, gate_top1=False)
        del got, want


def kimi_rounding_point(cfg, params, prompt: list[int],
                        tag: str = "kimi") -> None:
    """Diagnostic (reported, not gated): the expert flips between the plain
    route and the plain route with only its softmax probabilities kept in
    fp32 — what one moved rounding point does to the routing."""
    from repro_torch.models import attention
    from repro_torch.models.transformer import lm_forward
    tokens = torch.tensor([prompt], device="cuda")
    with RouteRecorder() as a:
        lm_forward(params, tokens, cfg, False, with_cache=False)
    plain_sdpa = attention._sdpa
    attention._sdpa = _sdpa_fp32_probs
    try:
        with RouteRecorder() as b:
            lm_forward(params, tokens, cfg, False, with_cache=False)
    finally:
        attention._sdpa = plain_sdpa
    routed, kept = _agreeing_positions(a, b)
    log(f"[{tag}] diagnostic: plain route with fp32 softmax probabilities vs "
        f"the plain route, {tokens.shape[1]} positions: expert choice flips "
        f"at {1.0 - float(routed.float().mean()):.4f}, capacity outcome "
        f"moved at {float((routed & ~kept).float().mean()):.4f}")


def moe_graph(cfg, params, seed: int, tag: str) -> dict:
    """The routed-MoE op graph (16 expert branches) through Session.compile
    into one CUDA graph, held against eager per-op execution."""
    from repro_torch.core import Session, SessionConfig, SimConfig
    from repro_torch.core.capture import run_sequential_uncompiled
    from repro_torch.models.opgraph_export import build_lm_opgraph

    t0 = time.perf_counter()
    graph = build_lm_opgraph(cfg, batch=BATCH, seq=SEQ, params=params)
    caps = [n.out_shape[0] for n in graph if ".dispatch" in n.name]
    log(f"[{tag}] op graph: {len(graph)} ops, {len(caps)} routed expert "
        f"branches with capacities {caps}, export "
        f"{time.perf_counter() - t0:.2f} s")

    def tokens(i):
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 500 + i)
        return torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g,
                             device="cuda")

    root = next(n.op_id for n in graph if n.fn is None)
    # -- the path's run: launch counts from 0 ----------------------------------
    reset_launches()
    sess = Session(SessionConfig(autotune=True,
                                 sim_cfg=SimConfig(head_of_line=True),
                                 calib_dir=CALIB_DIR))
    t0 = time.perf_counter()
    model = sess.compile(graph, inputs={root: tokens(0)})
    compile_s = time.perf_counter() - t0
    exe = model.executable
    stats = exe.program_stats()
    outputs = []
    for i in range(3):
        inputs = {"tokens": tokens(100 + i)}
        outputs.append((inputs, model(inputs)))
    torch.cuda.synchronize()
    launches = read_launches("branch_gemm", "grouped_gemm")
    routes = gemm_routes()
    # -- end of the path's run ---------------------------------------------------
    recorded = exe.replay.recorded_launches
    log(f"[{tag}] compile {compile_s:.2f} s; program_stats {json.dumps(stats)}"
        f"; launches in the graph (one forward) {recorded}; wrapper launches "
        f"over the run {launches}, by route {routes}")
    check_wgmma_only(tag, routes)
    if recorded["grouped_gemm"] != int(stats["n_grouped_gemm"]) or \
            recorded["grouped_gemm"] < 2:
        raise AssertionError(f"grouped_gemm launches per forward "
                             f"{recorded['grouped_gemm']}, program has "
                             f"{stats['n_grouped_gemm']} steps")
    for i, (inputs, outs) in enumerate(outputs):
        ref = run_sequential_uncompiled(graph, inputs, exe.output_ids)
        got, want = outs[-1].float(), ref[-1].float()
        if got.shape != (BATCH, SEQ, cfg.vocab_size) or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"bad logits {tuple(got.shape)}")
        rel, agree = _agreement(got, want)
        log(f"[{tag}] request {i}: logits rel_l2 {rel:.3e} (<= "
            f"{LOGITS_REL_L2}) top1 agreement {agree:.4f} (>= {TOP1_AGREE})")
        if rel > LOGITS_REL_L2 or agree < TOP1_AGREE:
            raise AssertionError(f"{tag} request {i} disagrees with eager "
                                 "per-op execution")
        del ref, got, want
    inputs = outputs[0][0]
    replay_ms = cuda_ms(lambda: model(inputs), iters=10)
    seq_ms = cuda_ms(lambda: run_sequential_uncompiled(graph, inputs,
                                                       exe.output_ids),
                     iters=3, warmup=1)
    log(f"[{tag}] per-forward ms: sequential eager {seq_ms:.3f}, CUDA-graph "
        f"replay {replay_ms:.3f} (median of 10)")
    profile_replay(exe.replay.graph.replay, tag=f"{tag}-profile")
    del outputs, model, exe, sess, graph
    free_card()
    return {"launches": launches, "recorded": recorded}


def _moe_layer_gate(cfg, params, gen, failures: list,
                    tag: str = "kimi") -> None:
    """The MoE layer, kernel route vs plain route on identical inputs (so
    routing cannot differ): a 512-token prefill and a decode tick."""
    from repro_torch.models.ffn import moe_ffn
    from repro_torch.models.transformer import layer_params
    p = layer_params(params["stacks"][1]["ffn"], 0)
    for shape in ((1, SEQ, cfg.d_model), (SLOTS, 1, cfg.d_model)):
        x = torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype)
        got, _ = moe_ffn(p, x, cfg, None, True)
        want, _ = moe_ffn(p, x, cfg, None, False)
        rel, _ = _agreement(got, want)
        log(f"[{tag}] {_dt(cfg.dtype)} MoE layer {list(shape)}, kernel route "
            f"vs plain route on the same input: rel_l2 {rel:.3e} (<= "
            f"{LOGITS_REL_L2})")
        if rel > LOGITS_REL_L2:
            failures.append(f"MoE layer {list(shape)}: rel_l2 {rel:.3e}")


def _slice_experts_(tree, n: int, dtype) -> None:
    """In place: keep the first ``n`` experts of every MoE subtree (the
    expert axis is -3 of the stacked ``[L, E, ..]`` and of an unstacked MTP
    block's ``[E, ..]`` weights) and cast every leaf to ``dtype`` (routers
    stay fp32).  Each old leaf is dropped as soon as its replacement exists,
    so the card never holds both trees."""
    for k in (range(len(tree)) if isinstance(tree, list) else list(tree)):
        v = tree[k]
        if k == "experts":
            for kk in list(v):
                v[kk] = v[kk].narrow(-3, 0, n).to(dtype).contiguous()
        elif k == "router":
            for kk in list(v):
                v[kk] = v[kk][..., :n].to(torch.float32).contiguous()
        elif isinstance(v, (dict, list)):
            _slice_experts_(v, n, dtype)
        else:
            tree[k] = v.to(dtype)


def _decode_tick(label: str, eng, specs: list[dict], tag: str) -> dict:
    """One decode tick at 8 active slots: graph vs eager (bit-equal, with
    recurrent state put back between the two), times, a profile."""
    from repro_torch.serving import Request
    from repro_torch.serving.engine import _leaves
    for s in specs[:SLOTS]:
        eng.submit(Request(rid=s["rid"], prompt=list(s["prompt"]),
                           max_tokens=SERVE_TOKENS))
    for _ in range(SLOTS + 1):          # 8 prefills, then a decode tick
        eng.step()
    if sum(r is not None for r in eng.slots) != SLOTS:
        raise AssertionError("not all slots active")
    values = [eng.last_token, eng.pos]
    if eng.paged:
        values.append(eng._block_table_array())
        bt = eng._on_device(values[2], torch.int32)

        def eager():
            return eng.model.paged_decode(
                eng.params, eng._on_device(eng.last_token, torch.long),
                eng.caches, bt, eng._on_device(eng.pos, torch.int32))[0]
    else:
        eager = eng._eager_decode
    kept = [t.clone() for t in _leaves(eng.caches)]
    graph_logits = eng._step(values).clone()
    for leaf, k in zip(_leaves(eng.caches), kept):
        leaf.copy_(k)
    eager_logits = eager()
    if not torch.equal(graph_logits, eager_logits):
        raise AssertionError(f"{label}: CUDA-graph decode tick differs from "
                             "the eager tick")
    del kept
    graph_ms = cuda_ms(lambda: eng._step(values))
    eager_ms = cuda_ms(eager, iters=10)
    log(f"[{tag}] {label} decode tick at {SLOTS} active slots (median): "
        f"CUDA-graph replay {graph_ms:.3f} ms (host copies included), eager "
        f"{eager_ms:.3f} ms; graph logits bit-equal to eager; launches "
        f"recorded in the graph {eng.decode_graph.recorded_launches}")
    profile_replay(lambda: eng._step(values), n=5,
                   what=f"{label} decode tick (graph)", tag=f"{tag}-profile")
    return {"graph_ms": graph_ms, "eager_ms": eager_ms}


def phase_kimi(seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import AdmissionConfig, InferenceEngine

    # 2 of 61 layers (the dense prefix and one MoE layer); the name must stay
    # the config's own, since the dense prefix is keyed on it
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b"), n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = Model(cfg).init(gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _param_leaves(params))
    log(f"[kimi] {cfg.name}: {cfg.n_layers} layers (dense prefix + MoE) "
        f"d={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
        f"head_dim={cfg.head_dim} experts={cfg.moe.n_experts} "
        f"top{cfg.moe.top_k} d_expert={cfg.moe.d_expert} shared="
        f"{cfg.moe.n_shared} vocab={cfg.vocab_size} {_dt(cfg.dtype)}: "
        f"{n_params / 1e9:.2f} B params, init {time.perf_counter() - t0:.2f}"
        f" s, {torch.cuda.memory_allocated() / 1e9:.1f} GB on the card")
    graph = moe_graph(cfg, params, seed, "kimi")

    failures: list[str] = []
    specs = serve_specs(cfg.vocab_size, seed)
    admission = AdmissionConfig(policy="edf", preemption=True,
                                expire_running=False)

    def engine(c, p):
        def make(paged: bool):
            return InferenceEngine(
                Model(c, use_kernels=True), p, max_slots=SLOTS,
                max_len=MAX_LEN, seed=seed, admission=admission,
                paged_kv=paged, page_size=PAGE,
                num_pages=1 + 2 * SLOTS * (MAX_LEN // PAGE) if paged else None)
        return make

    # -- the serving path's run: launch counts from 0 ---------------------------
    reset_launches()
    runs = serve_both(engine(cfg, params), specs, cfg.dtype)
    launches = read_launches("rmsnorm", "flash_attention", "decode_attention",
                             "paged_decode", "moe_gemm")
    check_flash_wgmma_only("kimi")
    check_decode_mma_only("kimi")
    check_moe_wgmma_only("kimi")
    # -- end of the serving path's run ------------------------------------------
    log(f"[kimi] wrapper launches over both serving runs {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the Kimi-K2 serve path launched no {name}")
    compare_streams(runs, exact=False, coupled=True)
    del runs

    by_len = sorted(specs, key=lambda s: len(s["prompt"]))
    prompts = [by_len[0], by_len[len(by_len) // 2], by_len[-1]]
    _moe_layer_gate(cfg, params, gen, failures)
    kimi_forward_gate(f"{cfg.name} bf16", cfg, params, prompts, failures,
                      gate_top1=False)
    kimi_rounding_point(cfg, params, prompts[1]["prompt"])
    ticks = {}
    for paged in (False, True):
        label = "paged" if paged else "dense"
        ticks[label] = _decode_tick(label, engine(cfg, params)(paged), specs,
                                    "kimi")
        free_card()
    for s in (by_len[0], by_len[-1]):
        tokens = torch.tensor([s["prompt"]], device="cuda")
        model = Model(cfg, use_kernels=True)
        ms = cuda_ms(lambda: model.prefill(params, {"tokens": tokens},
                                           cache_len=MAX_LEN), iters=5)
        log(f"[kimi] prefill {tokens.shape[1]} tokens (batch 1, eager, "
            f"kernel route, median of 5): {ms:.3f} ms")

    # fp32 at 64 of the 384 experts (an fp32 model of all of them is ~80 GB):
    # every width unchanged, still the sort dispatch (> 32 experts)
    cfg32 = dataclasses.replace(
        cfg, dtype=torch.float32,
        moe=dataclasses.replace(cfg.moe, n_experts=64))
    _slice_experts_(params, 64, torch.float32)
    params32, params = params, None
    free_card()
    log(f"[kimi] fp32 at {cfg32.moe.n_experts} experts: "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card")
    runs = serve_both(engine(cfg32, params32), specs, torch.float32)
    compare_streams(runs, exact=False, coupled=True)
    del runs
    _moe_layer_gate(cfg32, params32, gen, failures)
    kimi_forward_gate(f"{cfg.name} fp32 E=64", cfg32, params32, prompts,
                      failures, gate_top1=True)
    teacher_forced(cfg32, Model(cfg32, use_kernels=True),
                   Model(cfg32, use_kernels=False), params32, specs[:SLOTS],
                   seed, failures, gate_top1=True, steps=8)
    del params32
    free_card()
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches, "graph": graph, "ticks": ticks}


def free_card() -> None:
    """Return what dropped objects held to the card: engines keep their
    params and CUDA graph pools alive through reference cycles until the
    collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def _param_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _param_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _param_leaves(v)]
    return [tree]


# =============================================================================
# 9. DeepSeek-V3: the MLA kernel, the op graph and serving at full width
# =============================================================================

DS_LAYERS = 4           # the 3 dense-prefix layers and the first MoE layer


def _mla_operands(gen, dtype, lengths, ps: int, cfg) -> tuple:
    """The MLA form's operands at a decode tick of 8 slots: random queries,
    latent pages and ``wk_b`` at DeepSeek-V3's widths, a shuffled block
    table over ``MAX_LEN`` positions a slot (page 0 is the null page)."""
    m = cfg.mla
    maxp = MAX_LEN // ps
    n_pages = 1 + SLOTS * maxp

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(ps)) + 1
    return (rnd((SLOTS, cfg.n_heads, m.qk_nope_head_dim)),
            rnd((SLOTS, cfg.n_heads, m.qk_rope_head_dim)),
            rnd((n_pages, ps, m.kv_lora_rank)),
            rnd((n_pages, ps, m.qk_rope_head_dim)),
            rnd((m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim),
                m.qk_nope_head_dim ** -0.5),
            perm.reshape(SLOTS, maxp).to(torch.int32).cuda(),
            lengths.to(device="cuda", dtype=torch.int32),
            (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)


def mla_kernel_checks(env: dict, gen: torch.Generator) -> dict:
    """The MLA form of paged decode against its plain version at the serving
    shapes (8 slots of 1024 positions, 128 heads, Dk 576, Dv 512; 16- and
    128-position pages; every position attended and ragged lengths; bf16
    and fp32), and rows with no attended position.  Times are of the
    attention after the absorption, which both sides share."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_decode import ops as pops
    from repro_torch.kernels.paged_decode.kernel import (
        mla_wgmma_split_len, paged_mla_decode_cuda)
    from repro_torch.kernels.paged_decode.ref import (
        absorb_query, paged_decode_attention_ref,
        paged_mla_decode_attention_ref)
    F = torch.nn.functional
    hw = env["hw"]
    cfg = get_config("deepseek-v3-671b")
    h, rank, rope = cfg.n_heads, cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    results = {}
    ragged = torch.tensor(np.random.default_rng(4321).integers(
        17, MAX_LEN + 1, SLOTS))
    full = torch.full((SLOTS,), MAX_LEN)
    for ps in (PAGE, 128):
        for tag, lengths in (("full", full), ("ragged", ragged)):
            for dtype in (torch.bfloat16, torch.float32):
                args = _mla_operands(gen, dtype, lengths, ps, cfg)
                q_nope, q_pe, ckv, kpe, wk_b, bt, lens, scale = args
                path = pops.mla_route(q_pe, ckv, kpe)
                before = dict(pops.mla_launches_by_route)
                got = pops.paged_mla_decode_attention(*args)
                want = paged_mla_decode_attention_ref(*args)
                torch.cuda.synchronize()
                what = f"ps={ps} {tag} lengths"
                err = check_close(got, want, f"paged_decode_mla {what}")
                if {r: n - before[r] for r, n in
                        pops.mla_launches_by_route.items()
                        if n != before[r]} != {path: 1} or path != (
                            "wgmma" if dtype == torch.bfloat16 else "fp32"):
                    raise AssertionError(f"paged_decode_mla {what}: not one "
                                         f"launch on the {path} route")
                if dtype == torch.float32 and (ps, tag) != (PAGE, "full"):
                    log(f"[kernel] paged_decode_mla {what} {_dt(dtype)}: "
                        f"route {path} max_abs_err {err:.3g}")
                    continue
                simple_err = None
                if dtype == torch.bfloat16:
                    simple = pops.paged_mla_decode_simple_bf16(*args)
                    simple_err = check_close(simple, want, f"paged_decode_mla "
                                             f"simple route {what}")
                q_lat = absorb_query(q_nope, wk_b)
                out = torch.empty_like(got)
                q_cat = torch.cat([q_lat, q_pe], dim=-1)

                def kernel(q_lat=q_lat, q_pe=q_pe, ckv=ckv, kpe=kpe, bt=bt,
                           lens=lens, out=out, scale=scale, route=path):
                    paged_mla_decode_cuda(q_lat, q_pe, ckv, kpe, bt, lens,
                                          out, scale, route)

                def plain(q_cat=q_cat, ckv=ckv, kpe=kpe, bt=bt, lens=lens,
                          scale=scale):
                    k_cat = torch.cat([ckv, kpe], dim=-1)[:, :, None, :]
                    return paged_decode_attention_ref(
                        q_cat, k_cat, ckv[:, :, None, :], bt, lens, None,
                        scale)

                # the library yardstick: SDPA on the slab gathered beforehand
                # (one latent KV head broadcast under the 128 query heads)
                idx = bt.long()
                k_slab = torch.cat([ckv, kpe], -1)[idx].reshape(
                    SLOTS, 1, MAX_LEN, rank + rope)
                v_slab = ckv[idx].reshape(SLOTS, 1, MAX_LEN, rank)
                mask = (torch.arange(MAX_LEN, device="cuda")[None]
                        < lens[:, None])[:, None, None, :]

                def sdpa(q=q_cat[:, :, None], k=k_slab, v=v_slab, mask=mask,
                         scale=scale):
                    return F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)
                try:
                    lib_err = float((sdpa()[:, :, 0].float() - want.float())
                                    .abs().max())
                except RuntimeError as exc:
                    log(f"[kernel] SDPA refuses Dk {rank + rope} != Dv "
                        f"{rank}: {exc}")
                    sdpa = None
                else:
                    log(f"[kernel] SDPA on the gathered slab max_abs_err vs "
                        f"plain {lib_err:.3g}")
                n_valid = int(lens.sum())
                pages_read = int(((lens + ps - 1) // ps).sum())
                size = got.element_size()
                peak = (hw.peak_flops if dtype == torch.bfloat16
                        else FP32_PEAK[hw.name])
                # QK^T over rank + rope and P V over rank per attended
                # position and head; each attended page row read once, the
                # queries read and the output written once, plus the table
                # entries and lengths
                bound, by = gemm_bound_ms(
                    2.0 * h * (2 * rank + rope) * n_valid,
                    size * (n_valid * (rank + rope) + SLOTS * h * (2 * rank
                                                                   + rope))
                    + 4 * (pages_read + SLOTS), peak, hw.hbm_bw)
                kernel_ms = cuda_ms(kernel, flush=flush)
                simple_ms = None
                if dtype == torch.bfloat16:
                    simple_ms = cuda_ms(
                        lambda: kernel(route="simple"), flush=flush)
                if path == "wgmma" and tag == "full":
                    # the split rule's alternative: 8 splits, clusters of 8
                    eight = cuda_ms(lambda: paged_mla_decode_cuda(
                        q_lat, q_pe, ckv, kpe, bt, lens, out, scale, path,
                        split_len=MAX_LEN // 8), flush=flush)
                    rule = mla_wgmma_split_len(
                        SLOTS, h, MAX_LEN,
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count)
                    log(f"[kernel] paged_decode_mla ps={ps} {tag}: wgmma at "
                        f"{-(-MAX_LEN // rule)} splits (the rule) "
                        f"{kernel_ms:.4f} ms, at 8 splits {eight:.4f} ms")
                plain_ms = cuda_ms(plain, flush=flush)
                library_ms = (cuda_ms(sdpa, flush=flush)
                              if sdpa is not None else None)
                lib = "none" if library_ms is None else f"{library_ms:.4f}"
                same_call = "" if simple_ms is None else (
                    f" simple_ms {simple_ms:.4f} "
                    f"({simple_ms / kernel_ms:.2f}x; max_abs_err "
                    f"{simple_err:.3g})")
                log(f"[kernel] paged_decode_mla {what} B={SLOTS} H={h} "
                    f"Dk={rank + rope} Dv={rank} {_dt(dtype)} ({n_valid} "
                    f"positions attended): route {path} max_abs_err "
                    f"{err:.3g} kernel_ms {kernel_ms:.4f} "
                    f"({bound / kernel_ms:.3f} of the bound){same_call} "
                    f"plain_ms {plain_ms:.4f} library_ms(SDPA on the "
                    f"gathered slab) {lib} bound_us {bound * 1e3:.3f} ({by})")
                results[("paged_decode_mla", f"ps{ps} {tag}", dtype)] = dict(
                    max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=library_ms)
                del args, got, want, k_slab, v_slab
    # rows with no attended position (row 0's trailing entries on the null
    # page): V averaged over every table entry, as the plain version gives
    for dtype in (torch.bfloat16, torch.float32):
        args = list(_mla_operands(gen, dtype, torch.tensor([0, 300] * 4),
                                  PAGE, cfg))
        args[5][0, 20:] = 0
        got = pops.paged_mla_decode_attention(*args)
        want = paged_mla_decode_attention_ref(*args)
        torch.cuda.synchronize()
        err = check_close(got, want, "paged_decode_mla all-masked rows")
        mean = args[2][args[5][0].long()].float().reshape(-1, rank).mean(0)
        log(f"[kernel] paged_decode_mla all-masked rows {_dt(dtype)}: route "
            f"{pops.mla_route(*args[1:4])} max_abs_err vs plain {err:.3g} "
            f"(vs the mean of ckv over the table: "
            f"{float((got[0].float() - mean).abs().max()):.3g})")
    # table entries past each row's length pointing at pages of inf: never
    # read (the plain version, which gathers every entry, gets a clean copy
    # of the table)
    args = list(_mla_operands(gen, torch.bfloat16, ragged, PAGE, cfg))
    pages = args[2].shape[0]
    inf = float("inf")
    args[2] = torch.cat([args[2], torch.full_like(args[2][:1], inf)])
    args[3] = torch.cat([args[3], torch.full_like(args[3][:1], inf)])
    clean = args[5].clone()
    for row in range(SLOTS):
        args[5][row, -(-int(ragged[row]) // PAGE):] = pages
    got = pops.paged_mla_decode_attention(*args)
    want = paged_mla_decode_attention_ref(*args[:5], clean, *args[6:])
    torch.cuda.synchronize()
    err = check_close(got, want, "paged_decode_mla poisoned table entries")
    log(f"[kernel] paged_decode_mla ragged rows with the entries past each "
        f"length on a page of inf: route {pops.mla_route(*args[1:4])} "
        f"max_abs_err vs plain on a clean table {err:.3g}")
    del flush
    return results


def _mla_layer_gate(cfg, params, gen, failures: list) -> None:
    """The first layer's MLA paged decode, kernel route vs plain route on
    identical inputs (8 slots at ragged positions, 16-position pages of
    random latents): the attention routine is all that differs."""
    from repro_torch.models.attention import mla_paged_decode
    from repro_torch.models.transformer import layer_params
    m = cfg.mla
    maxp = MAX_LEN // PAGE
    n_pages = 1 + SLOTS * maxp

    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype)
    p = layer_params(params["stacks"][0]["attn"], 0)
    x = rnd((SLOTS, 1, cfg.d_model))
    pages = (rnd((n_pages, PAGE, m.kv_lora_rank)),
             rnd((n_pages, PAGE, m.qk_rope_head_dim)))
    bt = (torch.randperm(n_pages - 1, generator=torch.Generator()
                         .manual_seed(9)) + 1).reshape(SLOTS, maxp)
    bt = bt.to(torch.int32).cuda()
    pos = torch.tensor(np.random.default_rng(9).integers(17, MAX_LEN - 1,
                                                         SLOTS),
                       dtype=torch.int32, device="cuda")
    got, _ = mla_paged_decode(p, x, tuple(t.clone() for t in pages), bt, pos,
                              cfg, True)
    want, _ = mla_paged_decode(p, x, tuple(t.clone() for t in pages), bt, pos,
                               cfg, False)
    rel, _ = _agreement(got, want)
    log(f"[deepseek] {_dt(cfg.dtype)} MLA layer paged decode at {SLOTS} "
        f"slots, kernel route vs plain route on the same input: rel_l2 "
        f"{rel:.3e} (<= {LOGITS_REL_L2})")
    if rel > LOGITS_REL_L2:
        failures.append(f"MLA layer: rel_l2 {rel:.3e}")


def phase_deepseek(env: dict, gen: torch.Generator, seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import AdmissionConfig, InferenceEngine

    mla = mla_kernel_checks(env, gen)
    # 4 of 61 layers: DeepSeek-V3's layout up to its first MoE layer (the
    # dense prefix is keyed on the config's name, which stays its own)
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"),
                              n_layers=DS_LAYERS)
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(seed),
                             "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _param_leaves(params))
    n_mtp = sum(t.numel() for t in _param_leaves(params["mtp"]))
    m, e = cfg.mla, cfg.moe
    log(f"[deepseek] {cfg.name}: {cfg.n_layers} of 61 layers (3 dense "
        f"prefix + 1 MoE) d={cfg.d_model} heads={cfg.n_heads} MLA q_rank="
        f"{m.q_lora_rank} kv_rank={m.kv_lora_rank} nope={m.qk_nope_head_dim}"
        f" rope={m.qk_rope_head_dim} v_head={m.v_head_dim} d_ff={cfg.d_ff} "
        f"experts={e.n_experts} top{e.top_k} d_expert={e.d_expert} shared="
        f"{e.n_shared} vocab={cfg.vocab_size} {_dt(cfg.dtype)}, MTP head "
        f"built ({n_mtp / 1e9:.2f} B params, not run by serving): "
        f"{n_params / 1e9:.2f} B params, init {time.perf_counter() - t0:.2f}"
        f" s, {torch.cuda.memory_allocated() / 1e9:.1f} GB on the card")
    graph = moe_graph(cfg, params, seed, "deepseek")

    failures: list[str] = []
    specs = serve_specs(cfg.vocab_size, seed)
    admission = AdmissionConfig(policy="edf", preemption=True,
                                expire_running=False)

    def engine(c, p):
        def make(paged: bool):
            return InferenceEngine(
                Model(c, use_kernels=True), p, max_slots=SLOTS,
                max_len=MAX_LEN, seed=seed, admission=admission,
                paged_kv=paged, page_size=PAGE,
                num_pages=1 + 2 * SLOTS * (MAX_LEN // PAGE) if paged else None)
        return make

    # -- the serving path's run: launch counts from 0 ---------------------------
    reset_launches()
    runs = serve_both(engine(cfg, params), specs, cfg.dtype)
    launches = read_launches("rmsnorm", "paged_decode_mla", "moe_gemm")
    check_moe_wgmma_only("deepseek")
    check_mla_wgmma_only("deepseek")
    # -- end of the serving path's run ------------------------------------------
    log(f"[deepseek] wrapper launches over both serving runs {launches}; "
        f"the GQA attention kernels (MLA prefill and dense decode are plain, "
        f"as in the JAX package) "
        f"{read_launches('flash_attention', 'decode_attention', 'paged_decode')}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the DeepSeek-V3 serve path launched no "
                                 f"{name}")
    # the dense engine's latent attention is plain and the paged one's is
    # the kernel: in bf16 the two round differently (ROADMAP C12), so the
    # streams are reported here and held in fp32 below
    compare_streams(runs, exact=False, coupled=True, gated=False)
    del runs

    by_len = sorted(specs, key=lambda s: len(s["prompt"]))
    prompts = [by_len[0], by_len[len(by_len) // 2], by_len[-1]]
    _mla_layer_gate(cfg, params, gen, failures)
    _moe_layer_gate(cfg, params, gen, failures, tag="deepseek")
    kimi_forward_gate(f"{cfg.name} bf16", cfg, params, prompts, failures,
                      gate_top1=False, tag="deepseek")
    kimi_rounding_point(cfg, params, prompts[1]["prompt"], tag="deepseek")
    ticks = {}
    for paged in (False, True):
        label = "paged" if paged else "dense"
        ticks[label] = _decode_tick(label, engine(cfg, params)(paged), specs,
                                    "deepseek")
        free_card()
    for s in (by_len[0], by_len[-1]):
        tokens = torch.tensor([s["prompt"]], device="cuda")
        model = Model(cfg, use_kernels=True)
        ms = cuda_ms(lambda: model.prefill(params, {"tokens": tokens},
                                           cache_len=MAX_LEN), iters=5)
        log(f"[deepseek] prefill {tokens.shape[1]} tokens (batch 1, eager, "
            f"kernel route, median of 5): {ms:.3f} ms")

    # fp32 at 64 of the 256 experts (all of them in fp32 are ~107 GB), every
    # width unchanged, still the sort dispatch (> 32 experts); converted in
    # place, since the bf16 model and its fp32 copy do not fit together
    cfg32 = dataclasses.replace(
        cfg, dtype=torch.float32,
        moe=dataclasses.replace(cfg.moe, n_experts=64))
    _slice_experts_(params, 64, torch.float32)
    params32, params = params, None
    free_card()
    log(f"[deepseek] fp32 at {cfg32.moe.n_experts} experts: "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card")
    runs = serve_both(engine(cfg32, params32), specs, torch.float32)
    compare_streams(runs, exact=False, coupled=True)
    del runs
    _mla_layer_gate(cfg32, params32, gen, failures)
    _moe_layer_gate(cfg32, params32, gen, failures, tag="deepseek")
    kimi_forward_gate(f"{cfg.name} fp32 E=64", cfg32, params32, prompts,
                      failures, gate_top1=True, tag="deepseek")
    teacher_forced(cfg32, Model(cfg32, use_kernels=True),
                   Model(cfg32, use_kernels=False), params32, specs[:SLOTS],
                   seed, failures, gate_top1=True, steps=8,
                   paged_is_dense=False)
    del params32
    free_card()
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches, "graph": graph, "ticks": ticks, "mla": mla}


# =============================================================================
# 10. RWKV6-1.6B: op graph and serving at full width and depth
# =============================================================================

def rwkv_graph(cfg, params, seed: int) -> dict:
    from repro_torch.core import Session, SessionConfig, SimConfig
    from repro_torch.core.capture import run_sequential_uncompiled
    from repro_torch.models.opgraph_export import build_lm_opgraph

    graph = build_lm_opgraph(cfg, batch=BATCH, seq=SEQ, params=params)
    n_scan = sum(n.name.endswith(".wkv_scan") for n in graph)

    def tokens(i):
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 700 + i)
        return torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g,
                             device="cuda")

    root = next(n.op_id for n in graph if n.fn is None)
    # -- the path's run: launch counts from 0 ----------------------------------
    reset_launches()
    sess = Session(SessionConfig(autotune=True,
                                 sim_cfg=SimConfig(head_of_line=True),
                                 calib_dir=CALIB_DIR))
    t0 = time.perf_counter()
    model = sess.compile(graph, inputs={root: tokens(0)})
    compile_s = time.perf_counter() - t0
    exe = model.executable
    outputs = []
    for i in range(3):
        inputs = {"tokens": tokens(100 + i)}
        outputs.append((inputs, model(inputs)))
    torch.cuda.synchronize()
    launches = read_launches("branch_gemm", "rwkv6")
    routes = gemm_routes()
    # -- end of the path's run ---------------------------------------------------
    recorded = exe.replay.recorded_launches
    log(f"[rwkv] op graph: {len(graph)} ops, {n_scan} wkv_scan nodes; "
        f"compile {compile_s:.2f} s; program_stats "
        f"{json.dumps(exe.program_stats())}; launches in the graph (one "
        f"forward) {recorded}; wrapper launches over the run {launches}, by "
        f"route {routes}")
    check_wgmma_only("rwkv", routes)
    check_rwkv_chunked_only("rwkv")
    if recorded["rwkv6"] != n_scan:
        raise AssertionError(f"{recorded['rwkv6']} rwkv6 launches recorded "
                             f"for {n_scan} wkv_scan nodes")
    for i, (inputs, outs) in enumerate(outputs):
        ref = run_sequential_uncompiled(graph, inputs, exe.output_ids)
        got, want = outs[-1].float(), ref[-1].float()
        if got.shape != (BATCH, SEQ, cfg.vocab_size) or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"bad logits {tuple(got.shape)}")
        rel, agree = _agreement(got, want)
        log(f"[rwkv] request {i}: logits rel_l2 {rel:.3e} (<= "
            f"{LOGITS_REL_L2}) top1 agreement {agree:.4f} (>= {TOP1_AGREE})")
        if rel > LOGITS_REL_L2 or agree < TOP1_AGREE:
            raise AssertionError(f"rwkv request {i} disagrees with eager "
                                 "per-op execution")
    inputs = outputs[0][0]
    replay_ms = cuda_ms(lambda: model(inputs))
    walk_ms = cuda_ms(lambda: exe.call_uncompiled(inputs), iters=5)
    log(f"[rwkv] per-forward ms: eager step walk {walk_ms:.3f}, CUDA-graph "
        f"replay {replay_ms:.3f}")
    profile_replay(exe.replay.graph.replay, tag="rwkv-profile")
    return {"launches": launches, "recorded": recorded}


def rwkv_block_gate(cfg, params, prompt: list[int], failures: list) -> None:
    """Every RWKV block, kernel route vs plain route on identical inputs
    (the plain route's hidden states and states): its update of the
    residual stream over the prompt, and over one decode step from the
    prompt's state.  Relative L2 <= 2e-2 in the worst block."""
    from repro_torch.models.layers import embed
    from repro_torch.models.transformer import (block_seq, block_step,
                                                layer_params)
    tokens = torch.tensor([prompt], device="cuda")
    x = embed(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device="cuda")[None]
    pos = torch.tensor([x.shape[1]], dtype=torch.int32, device="cuda")
    worst_seq = worst_step = 0.0
    stack = params["stacks"][0]
    for li in range(cfg.n_layers):
        p = layer_params(stack, li)
        xk, _ = block_seq(p, x, cfg, positions, None, True, "rwkv")
        xp, state = block_seq(p, x, cfg, positions, None, False, "rwkv")
        worst_seq = max(worst_seq, _agreement(xk - x, xp - x)[0])
        step_in = xp[:, -1:]
        outs = []
        for route in (True, False):
            cache = {k: v.clone() for k, v in state.items()}
            outs.append(block_step(p, step_in, cache, pos, cfg, None, route,
                                   "rwkv")[0] - step_in)
        worst_step = max(worst_step, _agreement(*outs)[0])
        x = xp
    log(f"[rwkv] {_dt(cfg.dtype)} blocks on identical inputs, kernel route "
        f"vs plain route, {len(prompt)}-token prompt: worst block update "
        f"rel_l2 {worst_seq:.3e} over the prompt, {worst_step:.3e} over a "
        f"decode step (<= {LOGITS_REL_L2})")
    if max(worst_seq, worst_step) > LOGITS_REL_L2:
        failures.append(f"rwkv blocks on identical inputs: rel_l2 "
                        f"{worst_seq:.3e} / {worst_step:.3e}")


def rwkv_forward_gate(cfg, params, cfg32, params32, prompt: list[int],
                      failures: list) -> None:
    """Whole model in bf16: the kernel route's distance from the fp32 plain
    route must not exceed the bf16 plain route's own distance from it by
    more than a quarter (nor 2e-2, if that is larger); the two bf16 routes'
    distance from each other is reported."""
    from repro_torch.models.transformer import lm_forward
    tokens = torch.tensor([prompt], device="cuda")
    truth, _ = lm_forward(params32, tokens, cfg32, False, with_cache=False)
    got, _ = lm_forward(params, tokens, cfg, True, with_cache=False)
    want, _ = lm_forward(params, tokens, cfg, False, with_cache=False)
    rel_k, agree_k = _agreement(got, truth)
    rel_p, agree_p = _agreement(want, truth)
    rel, agree = _agreement(got, want)
    limit = max(LOGITS_REL_L2, 1.25 * rel_p)
    log(f"[rwkv] bf16 lm_forward, {tokens.shape[1]} positions, against the "
        f"fp32 plain route: kernel route rel_l2 {rel_k:.3e} top1 "
        f"{agree_k:.4f} (<= {limit:.3e}), plain route rel_l2 {rel_p:.3e} "
        f"top1 {agree_p:.4f}; kernel vs plain route rel_l2 {rel:.3e} top1 "
        f"{agree:.4f} (reported)")
    if not bool(torch.isfinite(got).all()) or rel_k > limit:
        failures.append(f"rwkv bf16 kernel route: rel_l2 {rel_k:.3e} from "
                        f"fp32 > {limit:.3e}")


def phase_rwkv(seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.transformer import lm_forward
    from repro_torch.serving import AdmissionConfig, InferenceEngine

    cfg = get_config("rwkv6-1.6b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = Model(cfg).init(gen, "cuda")
    n_params = sum(t.numel() for t in _param_leaves(params))
    log(f"[rwkv] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} heads "
        f"{cfg.d_model // cfg.ssm.head_dim}x{cfg.ssm.head_dim} d_ff="
        f"{cfg.d_ff} vocab={cfg.vocab_size} {_dt(cfg.dtype)}: "
        f"{n_params / 1e9:.3f} B params")
    graph = rwkv_graph(cfg, params, seed)
    specs = serve_specs(cfg.vocab_size, seed)
    admission = AdmissionConfig(policy="edf", preemption=True,
                                expire_running=False)

    def engine(c, p):
        return lambda paged: InferenceEngine(
            Model(c, use_kernels=True), p, max_slots=SLOTS, max_len=MAX_LEN,
            seed=seed, admission=admission)

    # -- the serving path's run: launch counts from 0 ---------------------------
    reset_launches()
    serve_both(engine(cfg, params), specs, cfg.dtype, modes=(False,))
    launches = read_launches("rmsnorm", "rwkv6")
    # -- end of the serving path's run ------------------------------------------
    log(f"[rwkv] wrapper launches over the serving run {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the RWKV6 serve path launched no {name}")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = _cast(params, torch.float32)
    serve_both(engine(cfg32, params32), specs, torch.float32, modes=(False,))

    failures: list[str] = []
    by_len = sorted(specs, key=lambda s: len(s["prompt"]))
    prompts = (by_len[0], by_len[len(by_len) // 2], by_len[-1])
    # fp32: the full gate, whole model (prefill and 32 decode steps)
    for s in prompts:
        tokens = torch.tensor([s["prompt"]], device="cuda")
        got, _ = lm_forward(params32, tokens, cfg32, True, with_cache=False)
        want, _ = lm_forward(params32, tokens, cfg32, False, with_cache=False)
        if not bool(torch.isfinite(got).all()) or \
                got.shape != (1, tokens.shape[1], cfg.vocab_size):
            raise AssertionError(f"bad logits {tuple(got.shape)}")
        _check_agreement(f"{cfg.name} float32 lm_forward logits, all "
                         f"{tokens.shape[1]} positions", got, want, failures)
    teacher_forced(cfg32, Model(cfg32, use_kernels=True),
                   Model(cfg32, use_kernels=False), params32, specs[:SLOTS],
                   seed, failures, gate_top1=True, paged=False)
    # bf16: each block on identical inputs, then the whole model against
    # the fp32 plain route beside the bf16 plain route
    for s in prompts:
        rwkv_block_gate(cfg, params, s["prompt"], failures)
    for s in prompts:
        rwkv_forward_gate(cfg, params, cfg32, params32, s["prompt"], failures)
    del params32
    tick = _decode_tick("dense", engine(cfg, params)(False), specs, "rwkv")
    # the longest prompt's prefill: every rwkv6 launch on the chunked route
    tokens = torch.tensor([by_len[-1]["prompt"]], device="cuda")
    reset_launches()
    Model(cfg, use_kernels=True).prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    check_rwkv_chunked_only(f"rwkv prefill {tokens.shape[1]} tokens")
    for s in (by_len[0], by_len[-1]):
        tokens = torch.tensor([s["prompt"]], device="cuda")
        model = Model(cfg, use_kernels=True)
        ms = cuda_ms(lambda: model.prefill(params, {"tokens": tokens}),
                     iters=5)
        log(f"[rwkv] prefill {tokens.shape[1]} tokens (batch 1, eager, "
            f"kernel route, median of 5): {ms:.3f} ms")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches, "graph": graph, "tick": tick}


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

    t_start = time.perf_counter()
    env = phase_environment()
    kernels = phase_kernels(env, gen)
    main_path = phase_main_path(args.seed)
    ragged = phase_ragged(gen)
    attention = phase_attention_kernels(env, gen)
    serve = phase_serve(args.seed)
    free_card()
    families = phase_moe_rwkv_kernels(env, gen)
    phase_masked_row(gen)
    kimi = phase_kimi(args.seed)
    free_card()
    deepseek = phase_deepseek(env, gen, args.seed)
    free_card()
    rwkv = phase_rwkv(args.seed)

    for path, launches in (("main", main_path["launches"]["branch_gemm"]),
                           ("ragged", ragged["launches"]["grouped_gemm"]),
                           ("kimi graph",
                            kimi["graph"]["launches"]["grouped_gemm"]),
                           ("deepseek graph (branch_gemm)",
                            deepseek["graph"]["launches"]["branch_gemm"]),
                           ("deepseek graph (grouped_gemm)",
                            deepseek["graph"]["launches"]["grouped_gemm"]),
                           ("rwkv graph", rwkv["graph"]["launches"]["rwkv6"])):
        if launches <= 0:
            raise AssertionError(f"the {path} path launched no kernel")
    bf16 = torch.bfloat16
    summary = {"kernels": [
        dict(name="branch_gemm", route="cuda",
             source="src/repro_torch/csrc/gemm.cu",
             replaces="src/repro/kernels/branch_gemm/kernel.py:46",
             launches=main_path["launches"]["branch_gemm"],
             **_json_row(kernels[("branch_gemm", "gate||up")])),
        dict(name="grouped_gemm", route="cuda",
             source="src/repro_torch/csrc/gemm.cu",
             replaces="src/repro/kernels/grouped_gemm/kernel.py:52",
             launches=kimi["graph"]["launches"]["grouped_gemm"],
             **_json_row(kernels[("grouped_gemm", "kimi gate||up")])),
        dict(name="rmsnorm", route="cuda",
             source="src/repro_torch/csrc/norm.cu",
             replaces="src/repro/kernels/rmsnorm/kernel.py:29",
             launches=serve["launches"]["rmsnorm"],
             **attention[("rmsnorm", "prefill d=896", bf16)]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:72",
             launches=serve["launches"]["flash_attention"],
             **attention[("flash_attention", "prefill", bf16)]),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:59",
             launches=serve["launches"]["decode_attention"],
             **attention[("decode_attention", "decode", bf16)]),
        dict(name="paged_decode", route="cuda",
             source="src/repro_torch/csrc/attention.cu",
             replaces="src/repro/kernels/paged_decode/kernel.py:70",
             launches=serve["launches"]["paged_decode"],
             **attention[("paged_decode", "decode", bf16)]),
        dict(name="paged_decode_mla", route="cuda",
             source="src/repro_torch/csrc/mla_decode.cu",
             replaces="src/repro/kernels/paged_decode/ops.py:59",
             launches=deepseek["launches"]["paged_decode_mla"],
             **deepseek["mla"][("paged_decode_mla", f"ps{PAGE} full", bf16)]),
        dict(name="moe_gemm", route="cuda",
             source="src/repro_torch/csrc/moe.cu",
             replaces="src/repro/kernels/moe_gemm/kernel.py:51",
             launches=kimi["launches"]["moe_gemm"],
             **_json_row(families[("moe_gemm", "tick C=1")])),
        dict(name="rwkv6", route="cuda",
             source="src/repro_torch/csrc/rwkv6.cu",
             replaces="src/repro/kernels/rwkv6/kernel.py:60",
             launches=rwkv["launches"]["rwkv6"],
             **_json_row(families[("rwkv6", "prefill T=512")])),
    ]}
    if [k["name"] for k in summary["kernels"]] != list(KERNELS):
        raise AssertionError("the kernels line must list every kernel")
    log(f"[done] chip_smoke took {time.perf_counter() - t_start:.1f} s")
    log(env["smi"].splitlines()[0])
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
