"""Smoke run of the PyTorch/CUDA port on one H100: build the kernels, hold
them against their plain versions, then drive the main path end to end.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits non-zero):
  1. environment: card name and power limit, torch/CUDA versions, kernel
     build time, ptxas registers and remarks (a remark on the flash, the
     moe_gemm or the MLA wgmma kernels, e.g. serialised wgmma, fails the
     run);
  2. kernels vs plain at the main path's shapes (plus the equal-shape
     GEMM branches of the Kimi-K2, RWKV6 and llava op graphs — llava's
     gate||up K 4096 F 14336 and wk||wv F 1024 at 512 rows — an
     off-lattice shape and fp32): route, error, kernel / plain / library times, bound,
     TFLOP/s and share of the bound; for bf16 also the simple route (the
     WMMA routine the wgmma route replaced) at the same shape;
  3. main path: full-width Qwen2-0.5B prefill graph (24 layers, batch 1,
     seq 512, bf16, random weights from --seed) → Session with measured
     calibration and autotune → lowering → one CUDA graph with each lane of
     the plan on a stream of its own → 3 requests by replay, each held
     against eager per-op execution on the card; every GEMM launch of this
     and the other op-graph phases (4, 8, 9, 10) on the wgmma route
     (launches counted by route); in this and the op graphs of phases 8, 9
     and 10 the same steps recorded on one stream, bit-equal to the lane
     recording on every request, the lanes, waits and syncs, each graph's
     kernel nodes and depth (the lane graph must not be a chain where the
     plan puts steps on two lanes), both replays timed, profiled (device
     busy as the union of kernel intervals, the share of it with two or
     more kernels at once) and their pools; here also the paper's
     baseline, the sequential CUDA Graph (one stream, topo order, no
     fusion), timed beside both;
  4. ragged capture: a hand-built ragged matmul fan-out captured into a CUDA
     graph through the grouped_gemm kernel, held against per-op execution;
  5. attention kernels: rmsnorm, flash_attention, decode_attention and
     paged_decode vs their plain versions at the serving shapes and at odd
     ones (D = 14, ragged T, null pages, clamped window starts), bf16 and
     fp32: error, kernel / plain / library times, bound; rmsnorm's onepass
     route at every width the registered models normalise (896, 2048, 7168,
     1536, 512, 1600, 2304, 4096) at 512 and 8 rows, beside the simple
     route (the routine it replaced) and F.rms_norm in the same call;
     flash_attention's bf16 prefills (Qwen2-0.5B at 512 and 1024 tokens,
     Kimi-K2's 64/8 heads of 112, GLM-4-9B's 32/2 of 128, Hymba-1.5B's 25/5
     of 64 over 980 + 128 positions with its 1024-position window) with its
     route, TFLOP/s, share of the bound and the simple route (the WMMA
     routine the wgmma route replaced) at the same shape; the decode pair
     at 8 slots of 1024 positions (Qwen2-0.5B's 14/2 heads of 64, Kimi-K2's
     64/8 of 112, GLM-4-9B's 32/2 of 128) and at Hymba-1.5B's 25/5 of 64
     over 1152 positions with every slot past its window, likewise, beside
     the simple route (the routine the mma route replaced), paged equal to
     dense bit for bit; flash at llava-next-mistral-7b's facade prefill (4
     rows of 2944 positions, 32/8 heads of 128); ``chunked_attention``
     (the plain route past 2048 positions) against ``_sdpa`` at S = 2000
     in chunks of 512 (the last ones short), at llava's heads and at MLA's 128 heads over one
     latent head (Dk 576, Dv 512), fp32 within 1e-5, bf16 relative L2 <=
     2e-2, both timed;
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
     the wgmma route; decode ticks graph vs eager; a 2304-token prompt's
     prefill on both routes (MLA attention chunked on both): finite
     logits, each layer's attention and FFN on identical inputs;
 10. RWKV6-1.6B at full width and depth (24 layers): the op graph (seq 512,
     the wkv_scan nodes launch rwkv6, every launch on the chunked route)
     through Session.compile, held against eager per-op execution; the
     serve trace on the dense-slab engine in bf16 and fp32 with phase 6's
     gates; a decode tick graph vs eager; the longest prompt's prefill with
     every rwkv6 launch on the chunked route;
 11. Llama-3.2-1B, MiniCPM-2B and GLM-4-9B at full width and depth, bf16,
     one after another: the op graph (batch 1, seq 512) with phase 3's
     gates (Session.compile into one CUDA graph on the plan's lanes, held
     against eager per-op execution, bit-equal to the same steps on one
     stream, depth below the kernel-node count, every GEMM launch on
     wgmma; MiniCPM-2B's plan fuses q, k and v and holds one lane, so its
     graph is a chain by construction); then phase 6's serve trace on dense
     and paged engines with its gates (kernel route vs plain route, paged
     vs dense up to a resume, graph tick == eager tick, flash on wgmma and
     the decode pair on mma) and fp32 top-1 gates; Llama-3.2-1B's bf16
     routes held by relative L2 as Qwen2-0.5B's, beside an fp32 serve run
     (paged == dense exactly); MiniCPM-2B's and GLM-4-9B's (40 layers,
     whose bf16 rounding alone moves the logits past 2e-2) block by block
     on identical inputs and against the fp32 plain route, as phase 10's;
 12. Hymba-1.5B at full width and depth (32 layers, attention in parallel
     with a Mamba head, 1024-position windows but in 3 global layers, 128
     meta tokens): the op graph at seq 512 with phase 11's gates and its
     lanes, waits, overlap and idle shares beside the one-stream recording,
     and the Mamba scan's share of the replay; the serve trace on the dense
     slab in bf16 and fp32 with phase 6's gates (bf16 held as phase 10's,
     block by block and against the fp32 plain route), plus one request whose
     980-token prompt and the meta tokens cross the window: its windowed
     prefill and windowed decode steps are held against the plain route;
     the scan's share of a prefill;
 13. Whisper-medium at full width and depth (24 encoder + 24 decoder
     layers, 1500 frames): the encoder-decoder op graph (batch 1, 224
     decoder tokens; the 48 cross-attention K/V GEMMs read the encoder
     output alone) with phase 3's gates, lanes beside one stream and the
     sequential CUDA Graph in the same call; then the model facade on 8
     segments of 1500 frames and Whisper's 4-token prompt: prefill (cache
     448) and 220 greedy ticks through one CUDA graph of the decode step,
     the graph tick bit-equal to the eager tick, every bf16 flash launch
     on wgmma and decode launch on mma, the kernel route against the plain
     route (fp32: the 8 greedy streams identical, logits within 1e-4;
     bf16: the prefill and each of the 220 ticks at the path's shapes,
     from the same caches and fed the same tokens, each decoder block on
     identical inputs and the whole model against the fp32 plain route),
     encode / prefill / tick times, tokens/s and the plain
     cross-attention's share of a tick;
 14. llava-next-mistral-7b at full width and depth (32 layers, ~7.2 B
     params): the op graph (text, batch 1, seq 512; the export has no
     frontend nodes, as the reference's) with phase 3's gates, lanes
     beside one stream and the sequential CUDA Graph; the facade on 4 rows
     of 2880 patch embeddings + 64 tokens (2944 positions, past 2048) and
     32 greedy ticks through one CUDA graph of the decode step, with
     Whisper's gates (graph tick == eager tick; flash on wgmma at S =
     2944, decode on mma; kernel route vs plain route — now
     ``chunked_attention`` — at the path's shapes, each route held against
     the fp32 plain route there by ``forward_gate``'s rule, blocks on
     identical inputs, the whole model against the fp32 plain route, fp32 greedy
     choices never parting), prefill times on both routes, tick time and
     idle shares; then phase 6's serve trace dense and paged (text
     prompts, as the reference's engine serves), held as GLM-4's;
 15. training (no kernel: the loss runs the plain route): the
     ``chunked_attention`` backward at S = T = 2304 in chunks of 2048
     against ``_sdpa``'s autograd at Qwen2-0.5B's, llava's and MLA's heads
     (fp32 rtol = atol = 1e-4, bf16 relative L2 <= 2e-2; time and peak
     memory of each route); one fp32 step of full-width Qwen2-0.5B at 2
     layers on the card against the same step on the CPU (loss 1e-5, grad
     leaves 1e-4, new params 1e-5); 30 steps of full-width, full-depth
     Qwen2-0.5B through ``launch/train.py`` (batch 8, seq 512, bf16
     params, fp32 moments: finite, falling loss; step ms, its split at the
     grads, tokens/s, peak memory, idle share, model-FLOP share); one
     step at seq 2304 (the chunked backward in every layer); a restart
     at 2 layers (12 steps with checkpoints, resumed to 18, within 5e-3 of
     18 uninterrupted steps);
 16. the ``REPRO_*`` performance flags (no kernel: each variable is set
     and restored around its own run, and a fresh graph or engine is
     built for each setting, since a recorded graph keeps its flags):
     ``causal_skip`` on ``chunked_attention``'s forward at Qwen2's, MLA's
     and llava's heads (2304 and 2944 positions, chunks of 2048), on
     DeepSeek-V3's 2304-token plain prefill (4 layers) and on a Qwen2-0.5B
     training step at 1 x 2304 (fp32 within 1e-5, bf16 relative L2 <=
     2e-2, both found bit-equal; times both ways); ``chunked_ce`` on that
     step (fp32 loss 1e-5, grad leaves 1e-4; step time and peak memory
     both ways); the cache-update modes on Qwen2-0.5B's 8 x 1024 decode
     tick (bit-equal); ``window_slice_decode`` on Hymba-1.5B, 8 rows of a
     3000-token prompt in 4096 + 128 slots, both routes (fp32 within 1e-5
     and top-1 equal; bf16 plain route 2e-2 and each bf16 tick against
     the fp32 plain tick; no decode kernel launched under the flag; graph
     tick == eager tick; ticks timed); ``kv_quant`` on DeepSeek-V3's dense
     decode at 8 rows after 1024 positions (logits within 5% of the bf16
     cache's, int8 / fp16 leaves, cache bytes 0.557 of bf16 from
     ``decode_state_specs``; ticks timed) and its engine (paged degrades
     to the dense slab, whose first admission raises, ROADMAP C19, no
     leaf written); ``[roofline]`` lines: ``cell_cost`` with the H100's
     terms beside the measured Qwen2 training step, Qwen2 tick and
     DeepSeek ticks.
 17. the distribution layer (no kernel: the reference's reaches no Pallas
     call) on the one card as a 1-rank NCCL mesh (``make_debug_mesh(1,
     1)``): params as ``DTensor``s laid out by ``param_shardings``, the
     batch by ``batch_specs``, the step under ``activation_rules``; an fp32
     step of full-width Qwen2-0.5B at 2 layers (batch 8, seq 512) sharded
     against plain on the same params and batch (loss 1e-5, grad leaves
     1e-4, bit-equality reported); the full-depth bf16 step both ways
     (CUDA events, median of 10 after 3 warm-up steps, and the idle share
     of one step each from torch.profiler: DTensor's host cost);
     ``collective_matmul`` and ``quantized_psum`` on the mesh against
     ``x @ w`` and the quantise-dequantise of ``g``; a checkpoint restored
     onto the mesh, bit-equal; the peak memory of the full-depth step
     both ways.  Then ``[mesh-gloo]``: the every-arch check of
     ``tests/test_torch_distributed.py`` on this machine's CPU and torch
     (one card holds no two NCCL ranks), two groups of 4 gloo ranks at
     once, half the eight decoder archs each, on a 2x2 mesh: the fp32
     smoke loss and grads against one process (1e-5 / 1e-4), the bf16
     loss (2e-2) and grads (the worst leaf within 1.25 x one process's,
     both against fp32), every product, combine and scan given plain
     tensors; one line an arch, any failure fails the run.  More than one
     card is not measured: the 16x16 and 2x16x16 collective numbers are
     the dry-run's reckoning.
 18. chaos (``phase_chaos``, ``[chaos]`` lines): the 14 fault scenarios of
     ``scripts/torch_chaos_smoke.py`` (imported from the checkout) at full
     width on the kernel route: ``kernel_compile`` on Qwen2-0.5B's
     full-depth op graph (bf16, seq 512; branch_gemm) and on GLM-4-9B at
     full width and 2 layers in fp32 (branch_gemm's fp32 route),
     ``grouped_gemm_route`` on a ragged group at Kimi-K2's expert widths
     (K 7168, F 2048, M 8 / 24 / 16, bf16; grouped_gemm): each raises out of
     lowering with no CUDA graph opened and nothing cached, then compiles
     the kernel route, cached, held against per-op execution (bf16 logits
     rel-L2 <= 2e-2 and top-1 >= 0.99; bf16 GEMMs 1e-2 + 1e-2 |ref|; fp32
     1e-5 x max|ref|), and a replay made to fail at call time raises; the
     calibration, disk-tier and plan sites on the Qwen2 graph (degraded
     build vs per-op, counters, events naming the fault, the disk tier's
     round trip and 16 concurrent writers on this machine's disk); the
     engine sites on Llama-3.2-1B at full width and depth in fp32 (prompts
     of 32-256 tokens, 16 output tokens, ``max_len`` 512; dense slab and
     16-position pages): ``decode_step`` corrupt (one FAILED) and raise (the
     watchdog's eager tick, probation back onto the recorded graph),
     admission, deadline and preemption faults, page allocation, block
     table and release faults (the dense-gather rung launches
     decode_attention; the pool's books balance; a failed release leaks,
     counted), each faulted run's streams equal to its fault-free run's;
     every line logs its rung's compile / replay / tick ms beside the
     fault-free run's and the kernels it launched, by route (none off its
     kernel route); a broken site, or a phase that launched none of
     branch_gemm, grouped_gemm, rmsnorm, flash_attention, decode_attention
     and paged_decode, fails the run.
The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package; needs the repository's ``src/`` and
``scripts/torch_chaos_smoke.py`` next to this file and a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch


def load_chaos():
    """``scripts/torch_chaos_smoke.py`` of this checkout, as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_chaos_smoke.py")
    spec = importlib.util.spec_from_file_location("torch_chaos_smoke", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


# The chaos script (phase 18) and the tolerances of every kernel and op-graph
# gate, which it defines once: BF16_TOL and FP32_TOL hold a kernel to its
# plain version (bf16 element-wise atol = rtol, fp32 relative to max|plain|),
# LOGITS_REL_L2 and TOP1_AGREE a main path to eager per-op execution and the
# kernel route to the plain route (top-1 gated in fp32 only, see
# _check_agreement).
chaos_script = load_chaos()
BF16_TOL, FP32_TOL = chaos_script.BF16_TOL, chaos_script.FP32_TOL
LOGITS_REL_L2, TOP1_AGREE = chaos_script.LOGITS_REL_L2, chaos_script.TOP1_AGREE
check_close = chaos_script.check_close
_agreement = chaos_script.agreement

BATCH, SEQ = 1, 512
TIMING_ITERS = 20
L2_FLUSH_BYTES = 64 * 2**20     # > the H100's 50 MB L2
# GPU-side spin before each timed kernel run, so the host's wrapper work is
# enqueued while the card is still busy and stays out of the event pair
HOLD_CYCLES = 1_000_000         # about 0.5 ms at the H100's clocks

# the calibration disk tier stays inside the checkout (git-ignored)
CALIB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "calib")

# calibration repeats of the routed MoE op graphs (phases 8 and 9): at full
# width the repacked candidates give each expert GEMM a wave of its own (its
# resource demand alone exceeds the cap), so they fuse nothing, and their
# estimated makespans trail the fusing candidates' by 0.3-1%; the default 3
# repeats leave per-op times noisy enough to flip that near-tie (ROADMAP
# C17)
MOE_CALIB_REPEATS = 20

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
    # branches Kimi-K2's, RWKV6's and llava's op graphs stack, off-lattice,
    # fp32
    for tag, (n, m, k, f), dtype in [
            ("gate||up", (2, 512, 896, 4864), torch.bfloat16),
            ("wk||wv", (2, 512, 896, 128), torch.bfloat16),
            ("kimi dense-prefix gate||up", (2, 512, 7168, 18432),
             torch.bfloat16),
            ("rwkv wr||wk||wv||wg", (4, 512, 2048, 2048), torch.bfloat16),
            ("llava gate||up", (2, 512, 4096, 14336), torch.bfloat16),
            ("llava wk||wv", (2, 512, 4096, 1024), torch.bfloat16),
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
    t0 = time.perf_counter()
    model = compile_autotuned("main", graph, {root: tokens(0)})
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
    lanes = compare_one_stream("main", exe, outputs)

    three_way("main", graph, inputs, outputs[0][1][-1], lanes)
    return {"launches": launches, "recorded": recorded}


def three_way(tag: str, graph, inputs: dict, want: torch.Tensor,
              lanes: dict) -> dict:
    """The paper's baseline, the sequential CUDA Graph (one stream, topo
    order, no fusion) of ``graph``, held against the Opara plan's logits
    ``want`` on the same request and timed beside the plan on one stream
    and on its lanes (``lanes``, from :func:`compare_one_stream`)."""
    from repro_torch.core import Session, SessionConfig
    seq_model = Session(SessionConfig(
        alloc_policy="sequential", order_policy="topo",
        calib_dir=CALIB_DIR)).compile(graph)
    got = seq_model(inputs)[-1].float()
    want = want.float()
    rel, agree = _agreement(got, want)
    log(f"[{tag}] sequential CUDA graph: {len(seq_model.executable.steps)} "
        f"steps on {seq_model.executable.lane_stats()['n_lanes']} lane; "
        f"logits vs the Opara plan's rel_l2 {rel:.3e} top1 agreement "
        f"{agree:.4f} (bit-equal {torch.equal(got, want)})")
    if rel > LOGITS_REL_L2 or agree < TOP1_AGREE:
        raise AssertionError(f"{tag}: the sequential CUDA graph disagrees "
                             "with the Opara plan")
    seq_graph = seq_model.executable.replay
    three = {"sequential": cuda_ms(lambda: seq_model(inputs)),
             "sequential_graph": cuda_ms(seq_graph.graph.replay)}
    log(f"[{tag}-three-way] per-forward ms (median of {TIMING_ITERS}, whole "
        f"call / graph alone): sequential CUDA graph "
        f"{three['sequential']:.3f} / {three['sequential_graph']:.3f}; "
        f"Opara plan on one stream (fusion only) {lanes['one']:.3f} / "
        f"{lanes['one_graph']:.3f}; Opara plan on its lanes "
        f"{lanes['lanes']:.3f} / {lanes['lanes_graph']:.3f}; sequential "
        f"graph pool bytes {seq_graph.pool_bytes}")
    profile_replay(seq_graph.graph.replay, what="forward (sequential)",
                   tag=f"{tag}-profile-sequential")
    return three


def busy_and_overlap(intervals) -> tuple[float, float]:
    """The length of the union of ``intervals`` ((start, end) pairs) and
    the length of the part of it that two or more of them cover."""
    points = sorted([(a, 1) for a, _ in intervals]
                    + [(b, -1) for _, b in intervals])
    busy = overlap = 0.0
    depth, last = 0, None
    for t, step in points:          # an end sorts before a start at one t
        if depth >= 1:
            busy += t - last
        if depth >= 2:
            overlap += t - last
        depth += step
        last = t
    return busy, overlap


def profile_replay(replay, n: int = 3, what: str = "forward",
                   tag: str = "profile") -> None:
    """Device time per ``what`` by kernel, from torch.profiler over ``n``
    calls of ``replay``, against the wall time of the same window.  Device
    busy is the union of the kernels' intervals (kernels on concurrent
    lanes overlap, so their sum can exceed the wall time); the overlap
    share is the part of it during which two or more ran at once."""
    from torch.autograd import DeviceType
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
    if not rows:
        log(f"[{tag}] torch.profiler recorded no device time")
        return
    busy_us, overlap_us = busy_and_overlap(
        [(e.time_range.start, e.time_range.end) for e in prof.events()
         if e.device_type == DeviceType.CUDA])
    busy = busy_us / n / 1e3
    log(f"[{tag}] per {what}: device busy {busy:.3f} ms of wall "
        f"{wall_ms:.3f} ms (idle share {max(0.0, 1 - busy / wall_ms):.3f}); "
        f"kernel time summed {sum(r[0] for r in rows):.3f} ms; two or more "
        f"kernels at once {overlap_us / busy_us:.3f} of busy")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"[{tag}] {ms:8.3f} ms {count:5d}x  {key[:90]}")


def compare_one_stream(tag: str, exe, outputs: list) -> dict:
    """The executable's lane recording (``exe.replay``, made by its first
    request) beside the same steps recorded on one stream
    (``CudaGraphReplay(exe.fn, args)``): lanes, waits and syncs, each
    graph's kernel nodes and depth, outputs bit-equal on every request of
    ``outputs`` ((inputs, outs) pairs), both replays timed (whole call and
    graph alone; returned, in ms) and profiled, and both graph pools.
    Fails on any
    differing output, on a graph of several lanes that is a chain, and on a
    one-stream graph that is not one."""
    from repro_torch.core.capture import CudaGraphReplay
    stats, lanes = exe.lane_stats(), exe.replay

    def args(inputs):
        return [inputs[n] for n in exe.input_names]

    one = CudaGraphReplay(exe.fn, args(outputs[0][0]))
    for i, (inputs, outs) in enumerate(outputs):
        if not all(torch.equal(a, b) for a, b in zip(outs, one(args(inputs)))):
            raise AssertionError(f"{tag} request {i}: the lane recording's "
                                 "outputs differ from the one-stream one's")
    nodes, depth = lanes.kernel_dag()
    one_nodes, one_depth = one.kernel_dag()
    log(f"[{tag}-lanes] plan streams {exe.stream_plan.n_streams}, lanes "
        f"holding a step {stats['n_lanes']} (recorded {lanes.n_lanes}), "
        f"waits {stats['n_waits']} (recorded {lanes.n_waits}), cross-lane "
        f"edges between steps {stats['n_cross_edges']}, count_syncs "
        f"{stats['n_syncs']}; lane graph {nodes} kernel nodes, depth "
        f"{depth}; one-stream graph {one_nodes} nodes, depth {one_depth}; "
        f"outputs of {len(outputs)} requests bit-equal")
    if stats["n_lanes"] > 1 and depth >= nodes:
        raise AssertionError(f"{tag}: {stats['n_lanes']} lanes recorded as "
                             "a chain")
    if (one_nodes, one_depth) != (nodes, nodes):
        raise AssertionError(f"{tag}: the one-stream graph has "
                             f"{one_nodes} nodes, depth {one_depth}")
    a = args(outputs[0][0])
    ms = {"one": cuda_ms(lambda: one(a)), "lanes": cuda_ms(lambda: lanes(a)),
          "lanes_graph": cuda_ms(lanes.graph.replay),
          "one_graph": cuda_ms(one.graph.replay)}
    log(f"[{tag}-lanes] per-forward ms (median of {TIMING_ITERS}): lanes "
        f"{ms['lanes']:.3f} (graph alone {ms['lanes_graph']:.3f}), one "
        f"stream {ms['one']:.3f} (graph alone {ms['one_graph']:.3f}); graph "
        f"pool bytes lanes {lanes.pool_bytes}, one stream {one.pool_bytes}")
    profile_replay(lanes.graph.replay, tag=f"{tag}-profile")
    profile_replay(one.graph.replay, what="forward (one stream)",
                   tag=f"{tag}-profile-one-stream")
    return ms


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
# glm4-9b's and hymba-1.5b's attention heads (query / KV, head dim); Hymba's
# windowed layers attend the last 1024 positions, and its 128 meta tokens
# ride in front of every prompt, so a 980-token prompt crosses the window
GLM4_HEADS, HYMBA_HEADS = (32, 2, 128), (25, 5, 64)
HYMBA_WINDOW, HYMBA_META, LONG_PROMPT = 1024, 128, 980
SLOTS, MAX_LEN, PAGE = 8, 1024, 16
# llava-next-mistral-7b's heads, and its facade's prefill: 4 rows of 2880
# anyres patches (base 576 + 4 tiles x 576) and a 64-token question each,
# then 32 greedy ticks
LLAVA_HEADS = (32, 8, 128)
LLAVA_ROWS, LLAVA_PATCHES, LLAVA_PROMPT, LLAVA_TICKS = 4, 2880, 64, 32
LLAVA_S = LLAVA_PATCHES + LLAVA_PROMPT
# DeepSeek-V3's MLA heads as chunked_attention sees them: 128 query heads
# over one latent head, Dk = rank 512 + rope 64, Dv = rank
MLA_HEADS = (128, 1, 576, 512)


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
    # 896, RWKV6-1.6B and Llama-3.2-1B 2048, Kimi-K2 and DeepSeek-V3 7168,
    # DeepSeek-V3's q_norm 1536 and kv_norm 512, Hymba-1.5B 1600,
    # MiniCPM-2B 2304, GLM-4-9B 4096) at a prefill's 512 rows and a decode
    # tick's 8, each beside the simple route (the routine the onepass route
    # replaced) and F.rms_norm in the same call; fp32; odd shapes ----------
    bf16, fp32 = torch.bfloat16, torch.float32
    norm_cases = [(f"{tag} d={d}", (n, d), bf16, True)
                  for d in (896, 2048, 7168, 1536, 512, 1600, 2304, 4096)
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
    # at 512 tokens and at the engine's max_len, Kimi-K2's 64/8 heads of 112,
    # GLM-4-9B's 32/2 of 128, Hymba-1.5B's 25/5 of 64 over the long request's
    # 980 + 128 positions with its 1024-position window), each timed beside
    # the simple route (the WMMA routine the wgmma route replaced) in the
    # same call; fp32; then odd shapes ----------------------------------------
    from repro_torch.configs import get_config
    kimi = get_config("kimi-k2-1t-a32b")
    kimi_heads = (kimi.n_heads, kimi.n_kv_heads, kimi.head_dim)
    long_s = LONG_PROMPT + HYMBA_META
    for tag, (b, s, h, kvh, d, window), dtype, timed in [
            ("prefill", (1, 512, HEADS, KV_HEADS, HEAD_DIM, 0), bf16, True),
            ("prefill S=1024", (1, MAX_LEN, HEADS, KV_HEADS, HEAD_DIM, 0),
             bf16, True),
            ("kimi prefill", (1, 512, *kimi_heads, 0), bf16, True),
            ("glm4 prefill", (1, 512, *GLM4_HEADS, 0), bf16, True),
            ("hymba prefill window=1024", (1, long_s, *HYMBA_HEADS,
                                           HYMBA_WINDOW), bf16, True),
            ("llava prefill S=2944", (LLAVA_ROWS, LLAVA_S, *LLAVA_HEADS, 0),
             bf16, True),
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

        # SDPA takes a window only as a boolean mask
        i = torch.arange(s, device="cuda")
        band = ((i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
                if window else None)

        def sdpa(q=q, k=k, v=v, band=band):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=band, is_causal=band is None, enable_gqa=True)
        lib_err = float((sdpa().transpose(1, 2).float() - want.float())
                        .abs().max())
        log(f"[kernel] SDPA causal{' windowed' if window else ''} "
            f"max_abs_err vs plain {lib_err:.3g}")
        pairs = _causal_pairs(s, s, window)
        results[("flash_attention", tag, dtype)] = measure(
            "flash_attention", f"{tag} B={b} S=T={s} H={h}/{kvh} D={d}",
            dtype, err,
            lambda q=q, k=k, v=v: fops.flash_attention(q, k, v, True, window),
            lambda q=q, k=k, v=v: flash_attention_ref(q, k, v, True, window),
            sdpa, "SDPA causal gqa" + (" band mask" if window else ""),
            4.0 * b * h * d * pairs,
            q.element_size() * (2 * b * s * h * d + 2 * b * s * kvh * d),
            path=path, simple_fn=simple_fn)

    # -- chunked_attention (the plain route's prefill past 2048 positions)
    # against _sdpa (its [S, T] route) on the same inputs at S = 2000, in
    # chunks of 512 (several KV chunks a query chunk, the last ones short):
    # llava's 32/8 heads of 128 and MLA's 128 heads over one latent head
    # (Dk 576, Dv 512); fp32 within 1e-5 of max|_sdpa|, bf16 relative L2 <=
    # 2e-2 (the probabilities are rounded unnormalised, ROADMAP C8) ----------
    from repro_torch.models.attention import (_sdpa, causal_window_mask,
                                              chunked_attention)
    n = 2000
    i = torch.arange(n, device="cuda")
    causal = causal_window_mask(i, i, None)
    for tag, (h, kvh, dk, dv) in (("llava", (*LLAVA_HEADS, 128)),
                                  ("mla", MLA_HEADS)):
        for dtype in (bf16, fp32):
            q = rnd((1, n, h, dk), dtype)
            k, v = rnd((1, n, kvh, dk), dtype), rnd((1, n, kvh, dv), dtype)
            scale = 192 ** -0.5 if tag == "mla" else None
            got = chunked_attention(q, k, v, scale=scale, q_chunk=512,
                                    kv_chunk=512)
            want = _sdpa(q, k, v, causal, scale=scale)
            rel = _agreement(got, want)[0]
            err = float((got.float() - want.float()).abs().max())
            if dtype == fp32:
                check_close(got, want, f"chunked_attention {tag}")
            elif rel > LOGITS_REL_L2:
                raise AssertionError(f"chunked_attention {tag} bf16: rel_l2 "
                                     f"{rel:.3e} from _sdpa")
            chunked_ms = cuda_ms(lambda: chunked_attention(
                q, k, v, scale=scale, q_chunk=512, kv_chunk=512), iters=5,
                flush=flush)
            sdpa_ms = cuda_ms(lambda: _sdpa(q, k, v, causal, scale=scale),
                              iters=5, flush=flush)
            log(f"[plain] chunked_attention {tag} B=1 S=T={n} H={h}/{kvh} "
                f"Dk={dk} Dv={dv} chunks 512 {_dt(dtype)}: vs _sdpa rel_l2 "
                f"{rel:.3e} max_abs_err {err:.3g} (fp32 <= {FP32_TOL} x "
                f"max|_sdpa|, bf16 rel_l2 <= {LOGITS_REL_L2}); chunked "
                f"{chunked_ms:.3f} ms, _sdpa {sdpa_ms:.3f} ms (median of 5)")
            del q, k, v, got, want

    # -- decode: 8 slots of 1024 positions, attended up to pos: Qwen2's 14/2
    # heads of 64 (bf16 and fp32), Kimi-K2's 64/8 heads of 112 and GLM-4-9B's
    # 32/2 of 128 (bf16); Hymba-1.5B's 25/5 of 64 over its 1024 + 128
    # positions, each slot past its 1024-position window (bf16); each bf16
    # row timed beside the simple route (the routine the mma route replaced)
    # in the same call, dense and through shuffled 16-position pages; the
    # paged decode must equal the dense one bit for bit ----------------------
    rng = np.random.default_rng(1234)
    pos_short = torch.tensor(rng.integers(17, MAX_LEN - 24, SLOTS),
                             device="cuda")
    hymba_t = MAX_LEN + HYMBA_META
    pos_long = torch.tensor(rng.integers(HYMBA_WINDOW + 8, hymba_t - 8, SLOTS),
                            device="cuda")
    for tag, (h, kvh, d), dtype, t, window in [
            ("decode", (HEADS, KV_HEADS, HEAD_DIM), bf16, MAX_LEN, 0),
            ("decode", (HEADS, KV_HEADS, HEAD_DIM), fp32, MAX_LEN, 0),
            ("kimi decode", kimi_heads, bf16, MAX_LEN, 0),
            ("glm4 decode", GLM4_HEADS, bf16, MAX_LEN, 0),
            ("hymba decode window=1024", HYMBA_HEADS, bf16, hymba_t,
             HYMBA_WINDOW)]:
        b = SLOTS
        pos = pos_long if window else pos_short
        q = rnd((b, h, d), dtype)
        k, v = rnd((b, t, kvh, d), dtype), rnd((b, t, kvh, d), dtype)
        k_pos = torch.arange(t, device="cuda")[None]
        valid = k_pos <= pos[:, None]
        starts = None
        if window:
            valid &= k_pos > pos[:, None] - window
            starts = (pos - window + 1).to(torch.int32)
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
        maxp = t // PAGE
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
        got_p = pops.paged_decode_attention(q, kp, vp, bt, lengths, starts)
        want_p = paged_decode_attention_ref(q, kp, vp, bt, lengths, starts)
        torch.cuda.synchronize()
        if pops.launches_by_route[path] != by_route[path] + 1:
            raise AssertionError(f"paged_decode {tag}: no {path} launch")
        err_p = check_close(got_p, want_p, f"paged_decode {tag}")
        if not torch.equal(got_p, got):
            raise AssertionError(f"paged_decode {tag} differs from "
                                 "decode_attention on the same positions")
        if dtype == bf16:
            check_close(pops.paged_decode_simple_bf16(q, kp, vp, bt, lengths,
                                                      starts),
                        want_p, f"paged_decode simple {tag}")

            def simple_p(q=q, kp=kp, vp=vp, bt=bt, lengths=lengths,
                         starts=starts):
                return pops.paged_decode_simple_bf16(q, kp, vp, bt, lengths,
                                                     starts)

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
        first_page = 0 if starts is None else starts // PAGE
        pages_read = int(((lengths + PAGE - 1) // PAGE - first_page).sum())
        results[("paged_decode", tag, dtype)] = measure(
            "paged_decode",
            f"{tag} B={b} ps={PAGE} MAXP={maxp} H={h}/{kvh} D={d} "
            f"({n_valid} positions attended; equal to decode_attention)",
            dtype, err_p,
            lambda q=q, kp=kp, vp=vp, bt=bt, lengths=lengths, starts=starts:
                pops.paged_decode_attention(q, kp, vp, bt, lengths, starts),
            lambda q=q, kp=kp, vp=vp, bt=bt, lengths=lengths, starts=starts:
                paged_decode_attention_ref(q, kp, vp, bt, lengths, starts),
            None,
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
               modes: tuple[bool, ...] = (False, True),
               tag: str = "serve") -> dict:
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
        log(f"[{tag}] {_dt(dtype)} {label}: {eng.tick} ticks, "
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


def check_decode_mma_only(tag: str, paged: bool = True) -> None:
    """A bf16 serving run's decode_attention and (with ``paged``)
    paged_decode launches since the last reset_launches() all took the mma
    route."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.paged_decode import ops as pops
    routes = {"decode_attention": dict(dops.launches_by_route)}
    if paged:
        routes["paged_decode"] = dict(pops.launches_by_route)
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
    cache_len = MAX_LEN + cfg.meta_tokens
    lens = torch.tensor([len(s["prompt"]) for s in specs], device="cuda")
    forced = torch.randint(1, cfg.vocab_size, (steps, SLOTS),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(seed + 1), device="cuda")
    bt = (torch.randperm(SLOTS * maxp, generator=torch.Generator()
                         .manual_seed(seed)) + 1).reshape(SLOTS, maxp)
    bt = bt.to(torch.int32).cuda()

    def prefilled(m):
        caches = init_decode_caches(cfg, SLOTS, cache_len, device="cuda")
        for i, s in enumerate(specs):
            tokens = torch.tensor([s["prompt"]], device="cuda")
            _, cache = m.prefill(params, {"tokens": tokens},
                                 cache_len=cache_len)
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


def plan_choice(plan, stats: dict) -> str:
    """The autotuner's pick, every candidate's estimated makespan and the
    fused GEMM groups of the captured program, on one line."""
    cands = ", ".join(f"{a}/{o}/{'repack' if r else 'plain'} {est:.3f}"
                      for a, o, r, est in plan.candidates)
    return (f"picked alloc {plan.alloc_policy} order {plan.order_policy} "
            f"repack {plan.repacked} est {plan.est_makespan_us:.3f} us of "
            f"n_candidates {plan.n_candidates} [{cands}]; n_branch_gemm "
            f"{int(stats['n_branch_gemm'])} n_grouped_gemm "
            f"{int(stats['n_grouped_gemm'])} of {int(stats['n_steps'])} steps")


def compile_autotuned(tag: str, graph, inputs: dict, **cfg_kw):
    """``Session.compile`` with the autotuner on (head-of-line simulator,
    the checkout's calibration tier).  Where its pick fuses no GEMM group,
    the repacked candidates' near-tie with the fusing ones (ROADMAP C17)
    went their way on this calibration's noise: the pick is logged, and
    the best-estimated unrepacked candidate, whose waves keep each fusable
    group whole, is compiled with its policies fixed, so the path still
    runs its GEMM kernels."""
    from repro_torch.core import Session, SessionConfig, SimConfig

    cfg_kw = dict(sim_cfg=SimConfig(head_of_line=True), calib_dir=CALIB_DIR,
                  **cfg_kw)
    model = Session(SessionConfig(autotune=True, **cfg_kw)).compile(
        graph, inputs=inputs)
    stats = model.executable.program_stats()
    if stats["n_branch_gemm"] or stats["n_grouped_gemm"]:
        return model
    plain = [c for c in model.plan.candidates if not c[2]]
    if not plain:
        return model
    alloc, order, _, est = min(plain, key=lambda c: c[3])
    log(f"[{tag}] the autotuned plan fused no GEMM group (C17 near-tie): "
        f"{plan_choice(model.plan, stats)}; compiling {alloc}/{order}/plain "
        f"(est {est:.3f} us) with its policies fixed")
    return Session(SessionConfig(alloc_policy=alloc, order_policy=order,
                                 **cfg_kw)).compile(graph, inputs=inputs)


def moe_graph(cfg, params, seed: int, tag: str) -> dict:
    """The routed-MoE op graph (16 expert branches) through Session.compile
    into one CUDA graph, held against eager per-op execution."""
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
    t0 = time.perf_counter()
    model = compile_autotuned(tag, graph, {root: tokens(0)},
                              calibration_repeats=MOE_CALIB_REPEATS)
    compile_s = time.perf_counter() - t0
    exe = model.executable
    stats = exe.program_stats()
    choice = plan_choice(model.plan, stats)
    log(f"[{tag}] compile: {choice}")
    if not stats["n_branch_gemm"] and not stats["n_grouped_gemm"]:
        raise AssertionError(f"[{tag}] the autotuned plan fused no GEMM "
                             f"group: {choice}")
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
    compare_one_stream(tag, exe, outputs)
    del outputs, model, exe, graph
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


DS_LONG = 2304          # past 2048 positions: MLA prefill runs chunked


def deepseek_long_prefill(cfg, params, seed: int, failures: list) -> None:
    """One prompt of 2304 tokens through the facade's prefill on both
    routes (MLA's latent attention chunked on both, s·s > 2^22): it must
    finish with finite logits; then each layer's attention and FFN, kernel
    route vs plain route on identical inputs (the plain route's hidden
    states, so the MoE routing cannot differ), relative L2 <= 2e-2."""
    from repro_torch.models import Model
    from repro_torch.models.attention import CHUNK_THRESHOLD, attn_prefill
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.transformer import (_embed_inputs, _ffn,
                                                layer_params, stack_meta)
    if DS_LONG * DS_LONG <= CHUNK_THRESHOLD:
        raise AssertionError("the long prompt does not reach the chunked "
                             "route")
    g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 910)
    tokens = torch.randint(1, cfg.vocab_size, (1, DS_LONG), generator=g,
                           device="cuda")
    for route in (True, False):
        model = Model(cfg, use_kernels=route)
        logits, _ = model.prefill(params, {"tokens": tokens})
        if tuple(logits.shape) != (1, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"deepseek {DS_LONG}-token prefill: bad "
                                 f"logits {tuple(logits.shape)}")
        ms = cuda_ms(lambda: model.prefill(params, {"tokens": tokens}),
                     iters=3, warmup=1)
        name = "kernel" if route else "plain"
        log(f"[deepseek] prefill {DS_LONG} tokens ({name} route, MLA "
            f"attention chunked, batch 1, eager, median of 3): {ms:.3f} ms, "
            f"logits finite")
        del logits
    x = _embed_inputs(params, tokens, cfg)
    positions = torch.arange(DS_LONG, device="cuda")[None]
    worst = {"attention": 0.0, "ffn": 0.0}
    for stack, (kind, n, _) in zip(params["stacks"], stack_meta(cfg)):
        for li in range(n):
            p = layer_params(stack, li)
            h = apply_norm(p["norm1"], x, cfg.norm, False)
            a_k, a_p = (attn_prefill(p["attn"], h, cfg, positions, None,
                                     route)[0] for route in (True, False))
            worst["attention"] = max(worst["attention"],
                                     _agreement(a_k, a_p)[0])
            x = x + a_p * cfg.residual_scale
            h = apply_norm(p["norm2"], x, cfg.norm, False)
            f_k, f_p = (_ffn(p["ffn"], h, cfg, route, kind)[0]
                        for route in (True, False))
            worst["ffn"] = max(worst["ffn"], _agreement(f_k, f_p)[0])
            x = x + f_p * cfg.residual_scale
    log(f"[deepseek] {_dt(cfg.dtype)} {DS_LONG}-token prefill, each of the "
        f"{cfg.n_layers} layers on identical inputs, kernel route vs plain "
        f"route: worst attention rel_l2 {worst['attention']:.3e}, worst FFN "
        f"(dense prefix, MoE) {worst['ffn']:.3e} (<= {LOGITS_REL_L2})")
    if max(worst.values()) > LOGITS_REL_L2:
        failures.append(f"deepseek {DS_LONG}-token prefill layers: {worst}")


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
    free_card()
    deepseek_long_prefill(cfg, params, seed, failures)
    free_card()
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

def token_inputs(cfg, seed: int, salt: int):
    """The input maker of an LM op graph: request ``i``'s tokens, batch
    ``BATCH`` of ``SEQ``, from ``seed`` and ``salt``."""
    def make(i):
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + salt + i)
        return {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                                        generator=g, device="cuda")}
    return make


def op_graph_path(tag: str, graph, make_inputs, out_shape: tuple,
                  kernels: tuple[str, ...] = ("branch_gemm",),
                  check=None) -> dict:
    """An op graph through Session.compile (measured calibration,
    autotune) into one CUDA graph on the plan's lanes: 3 requests
    (``make_inputs(i)``, a dict by input name), launch counts of
    ``kernels`` from 0, every GEMM launch on the wgmma route,
    ``check(exe, recorded)`` (the arch's own gates), each request's logits
    (``out_shape``) held against eager per-op execution, per-forward times,
    and :func:`compare_one_stream`."""
    from repro_torch.core.capture import run_sequential_uncompiled

    calib = make_inputs(0)
    # -- the path's run: launch counts from 0 ----------------------------------
    reset_launches()
    t0 = time.perf_counter()
    model = compile_autotuned(tag, graph, {n.op_id: calib[n.name]
                                           for n in graph if n.fn is None})
    compile_s = time.perf_counter() - t0
    exe = model.executable
    outputs = []
    t0 = time.perf_counter()
    for i in range(3):
        inputs = make_inputs(100 + i)
        outputs.append((inputs, model(inputs)))
        if i == 0:
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_launches(*kernels)
    routes = gemm_routes()
    # -- end of the path's run ---------------------------------------------------
    recorded = exe.replay.recorded_launches
    stages = {k: round(v, 3) for k, v in model.explain()["stages_ms"].items()}
    log(f"[{tag}] op graph: {len(graph)} ops; compile {compile_s:.2f} s, "
        f"stages_ms {json.dumps(stages)}; first request (warm-up + record + "
        f"replay) {first_s:.3f} s; program_stats "
        f"{json.dumps(exe.program_stats())}; launches in the graph (one "
        f"forward) {recorded}; wrapper launches over the run {launches}, by "
        f"route {routes}")
    check_wgmma_only(tag, routes)
    if check is not None:
        check(exe, recorded)
    for i, (inputs, outs) in enumerate(outputs):
        ref = run_sequential_uncompiled(graph, inputs, exe.output_ids)
        got, want = outs[-1].float(), ref[-1].float()
        if got.shape != out_shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"bad logits {tuple(got.shape)}")
        rel, agree = _agreement(got, want)
        log(f"[{tag}] request {i}: logits rel_l2 {rel:.3e} (<= "
            f"{LOGITS_REL_L2}) top1 agreement {agree:.4f} (>= {TOP1_AGREE})")
        if rel > LOGITS_REL_L2 or agree < TOP1_AGREE:
            raise AssertionError(f"{tag} request {i} disagrees with eager "
                                 "per-op execution")
    if torch.equal(outputs[0][1][-1], outputs[1][1][-1]):
        raise AssertionError(f"{tag}: two requests gave identical logits")
    inputs = outputs[0][0]
    replay_ms = cuda_ms(lambda: model(inputs))
    walk_ms = cuda_ms(lambda: exe.call_uncompiled(inputs), iters=5)
    log(f"[{tag}] per-forward ms: eager step walk {walk_ms:.3f}, CUDA-graph "
        f"replay {replay_ms:.3f}")
    lanes = compare_one_stream(tag, exe, outputs)
    return {"launches": launches, "recorded": recorded, "graph": graph,
            "lanes": lanes, "first": outputs[0]}


def lm_graph_path(tag: str, cfg, params, seed: int, salt: int,
                  kernels: tuple[str, ...] = ("branch_gemm",),
                  check=None) -> dict:
    """:func:`op_graph_path` on an LM's prefill op graph (batch 1, seq
    512)."""
    from repro_torch.models.opgraph_export import build_lm_opgraph
    graph = build_lm_opgraph(cfg, batch=BATCH, seq=SEQ, params=params)
    return op_graph_path(tag, graph, token_inputs(cfg, seed, salt),
                         (BATCH, SEQ, cfg.vocab_size), kernels, check)


def rwkv_graph(cfg, params, seed: int) -> dict:
    """The RWKV op graph: each wkv_scan node launches rwkv6 on the chunked
    route."""
    def check(exe, recorded):
        n_scan = sum(n.name.endswith(".wkv_scan") for n in exe.graph)
        check_rwkv_chunked_only("rwkv")
        if recorded["rwkv6"] != n_scan:
            raise AssertionError(f"{recorded['rwkv6']} rwkv6 launches "
                                 f"recorded for {n_scan} wkv_scan nodes")

    return lm_graph_path("rwkv", cfg, params, seed, 700,
                         ("branch_gemm", "rwkv6"), check)


def _one_longer(kv):
    """A fresh copy of a K/V slab pair, one position longer."""
    return tuple(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 1)) for t in kv)


def block_gate(tag: str, what: str, x, blocks, failures: list) -> None:
    """Every block, kernel route vs plain route on identical inputs (the
    plain route's hidden states and caches): its update of the residual
    stream over the sequence ``x``, and over one decode step after it.
    Each block is a pair ``seq(x, use_kernels) -> (x, cache)``,
    ``step(x, cache, use_kernels) -> x`` (``step`` works on a fresh copy of
    the cache).  Relative L2 <= 2e-2 in the worst block."""
    worst_seq = worst_step = 0.0
    for seq, step in blocks:
        xk, _ = seq(x, True)
        xp, cache = seq(x, False)
        worst_seq = max(worst_seq, _agreement(xk - x, xp - x)[0])
        step_in = xp[:, -1:].contiguous()
        outs = [step(step_in, cache, route) - step_in
                for route in (True, False)]
        worst_step = max(worst_step, _agreement(*outs)[0])
        x = xp
    log(f"[{tag}] {what} blocks on identical inputs, kernel route vs plain "
        f"route, {x.shape[0]} rows x {x.shape[1]} positions: worst block "
        f"update rel_l2 {worst_seq:.3e} over the positions, {worst_step:.3e} "
        f"over a decode step (<= {LOGITS_REL_L2})")
    if max(worst_seq, worst_step) > LOGITS_REL_L2:
        failures.append(f"{tag} blocks on identical inputs: rel_l2 "
                        f"{worst_seq:.3e} / {worst_step:.3e}")


def lm_blocks(cfg, params, prompt, extra_embeds=None) -> tuple:
    """``block_gate``'s input and blocks for a one-stack model (dense, RWKV,
    hybrid or vlm): the prompt (a token list, one row, or a [B, S] tensor)
    with its meta tokens or after its projected patch embeddings
    ``extra_embeds``, each block's prefill and its decode step after the
    prompt."""
    from repro_torch.models.transformer import (_embed_inputs, block_seq,
                                                block_step, layer_params,
                                                stack_meta)
    tokens = (prompt if isinstance(prompt, torch.Tensor)
              else torch.tensor([prompt], device="cuda"))
    x = _embed_inputs(params, tokens, cfg, extra_embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, device="cuda")[None].expand(b, s)
    pos = torch.full((b,), s, dtype=torch.int32, device="cuda")
    (kind, n, windows), = stack_meta(cfg)

    def block(p, window):
        def seq(h, route):
            return block_seq(p, h, cfg, positions, window, route, kind)[:2]

        def step(h, cache, route):
            cache = (_one_longer(cache) if isinstance(cache, tuple) else
                     {k: _one_longer(v) if k == "kv" else v.clone()
                      for k, v in cache.items()})
            return block_step(p, h, cache, pos, cfg, window, route, kind)[0]
        return seq, step

    return x, [block(layer_params(params["stacks"][0], li),
                     windows[li] or None) for li in range(n)]


def forward_gate(tag: str, what: str, forward, cfg, params, cfg32, params32,
                 failures: list) -> None:
    """Whole model in bf16, ``forward(params, cfg, use_kernels) -> logits``:
    the kernel route's distance from the fp32 plain route must not exceed
    the bf16 plain route's own distance from it by more than a quarter (nor
    2e-2, if that is larger); the two bf16 routes' distance from each other
    is reported."""
    truth = forward(params32, cfg32, False)
    got = forward(params, cfg, True)
    want = forward(params, cfg, False)
    rel_k, agree_k = _agreement(got, truth)
    rel_p, agree_p = _agreement(want, truth)
    rel, agree = _agreement(got, want)
    limit = max(LOGITS_REL_L2, 1.25 * rel_p)
    log(f"[{tag}] bf16 {what}, {tuple(got.shape[:-1])} positions, against "
        f"the fp32 plain route: kernel route rel_l2 {rel_k:.3e} top1 "
        f"{agree_k:.4f} (<= {limit:.3e}), plain route rel_l2 {rel_p:.3e} "
        f"top1 {agree_p:.4f}; kernel vs plain route rel_l2 {rel:.3e} top1 "
        f"{agree:.4f} (reported)")
    if not bool(torch.isfinite(got).all()) or rel_k > limit:
        failures.append(f"{tag} bf16 kernel route: rel_l2 {rel_k:.3e} from "
                        f"fp32 > {limit:.3e}")


def lm_logits(prompt: list[int]):
    """``forward_gate``'s forward for a decoder LM over one prompt."""
    from repro_torch.models.transformer import lm_forward
    tokens = torch.tensor([prompt], device="cuda")
    return lambda p, c, k: lm_forward(p, tokens, c, k, with_cache=False)[0]


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
        block_gate("rwkv", _dt(cfg.dtype), *lm_blocks(cfg, params,
                                                      s["prompt"]), failures)
    for s in prompts:
        forward_gate("rwkv", "lm_forward", lm_logits(s["prompt"]), cfg,
                     params, cfg32, params32, failures)
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


# =============================================================================
# 11. llama3.2-1b, minicpm-2b and glm4-9b; 12. hymba-1.5b
# =============================================================================

DENSE_ARCHS = ("llama3.2-1b", "minicpm-2b", "glm4-9b")
FP32_ARCHS = ("llama3.2-1b",)   # the fp32 serve run
# 40 layers: bf16 rounding noise alone moves the whole model's logits past
# 2e-2 (MiniCPM-2B's two bf16 routes differ by 2.1e-2), so the bf16 routes
# are held block by block and against the fp32 plain route, as RWKV's are
BLOCK_GATED = ("minicpm-2b", "glm4-9b")


def _init_full(tag: str, name: str, seed: int):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(name)
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(seed),
                             "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _param_leaves(params))
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} heads="
        f"{cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.head_dim} d_ff="
        f"{cfg.d_ff} vocab={cfg.vocab_size} {_dt(cfg.dtype)}"
        + (f" window={cfg.window} global={cfg.global_layers} meta="
           f"{cfg.meta_tokens} ssm N={cfg.ssm.state_dim} expand="
           f"{cfg.ssm.expand}" if cfg.family == "hybrid" else "")
        + f": {n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    return cfg, params


def serve_arch(tag: str, cfg, params, seed: int, specs: list[dict],
               paged: bool, fp32_serve: bool, prompts: list[dict],
               bf16_blocks: bool = False) -> dict:
    """Phase 6's serve trace on ``cfg`` at full width: dense (and, with
    ``paged``, paged) engines in bf16 with every flash_attention launch on
    wgmma and every decode launch on mma, paged against dense up to a
    resume; the kernel route against the plain route (``lm_forward`` on
    ``prompts`` and 32 teacher-forced decode steps: relative L2 in bf16;
    with fp32 weights also top-1 in fp32); with ``fp32_serve`` an fp32
    serve run whose paged and dense streams must be equal; decode ticks
    graph vs eager; prefill times by length.  With ``bf16_blocks`` (a
    model whose bf16 rounding noise alone moves its logits past 2e-2, as
    RWKV's does) the bf16 routes are held as phase 10 holds them: each
    block on identical inputs, and the whole model against the fp32 plain
    route (:func:`forward_gate`)."""
    from repro_torch.models import Model
    from repro_torch.models.transformer import lm_forward
    from repro_torch.serving import AdmissionConfig, InferenceEngine
    modes = (False, True) if paged else (False,)

    def engine(c, p):
        return lambda paged_: InferenceEngine(
            Model(c, use_kernels=True), p, max_slots=SLOTS, max_len=MAX_LEN,
            seed=seed, admission=AdmissionConfig(policy="edf",
                                                 preemption=True,
                                                 expire_running=False),
            paged_kv=paged_, page_size=PAGE,
            num_pages=1 + 2 * SLOTS * (MAX_LEN // PAGE) if paged_ else None)

    # -- the serving path's run: launch counts from 0 ---------------------------
    reset_launches()
    runs = serve_both(engine(cfg, params), specs, cfg.dtype, modes, tag)
    names = ("rmsnorm", "flash_attention", "decode_attention") + (
        ("paged_decode",) if paged else ())
    launches = read_launches(*names)
    check_flash_wgmma_only(tag)
    check_decode_mma_only(tag, paged)
    # -- end of the serving path's run ------------------------------------------
    log(f"[{tag}] wrapper launches over the bf16 serving runs {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the {cfg.name} serve path launched no "
                                 f"{name}")
    if paged:
        compare_streams(runs, exact=False)
    del runs
    failures: list[str] = []
    model, plain = Model(cfg, use_kernels=True), Model(cfg, use_kernels=False)
    for s in prompts:
        if bf16_blocks:
            block_gate(tag, _dt(cfg.dtype), *lm_blocks(cfg, params,
                                                       s["prompt"]), failures)
            continue
        tokens = torch.tensor([s["prompt"]], device="cuda")
        got, _ = lm_forward(params, tokens, cfg, True, with_cache=False)
        want, _ = lm_forward(params, tokens, cfg, False, with_cache=False)
        if not bool(torch.isfinite(got).all()) or got.shape != (
                1, tokens.shape[1] + cfg.meta_tokens, cfg.vocab_size):
            raise AssertionError(f"bad logits {tuple(got.shape)}")
        _check_agreement(f"{cfg.name} bfloat16 lm_forward logits, all "
                         f"{got.shape[1]} positions", got, want, failures,
                         gate_top1=False)
        del got, want
    if not bf16_blocks:
        teacher_forced(cfg, model, plain, params, specs[:SLOTS], seed,
                       failures, gate_top1=False, paged=paged)
    if fp32_serve or bf16_blocks:
        free_card()
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        params32 = _cast(params, torch.float32)
    if fp32_serve:
        runs = serve_both(engine(cfg32, params32), specs, torch.float32,
                          modes, tag)
        if paged:
            compare_streams(runs, exact=True)
        del runs
    if fp32_serve or bf16_blocks:
        for s in prompts:
            if bf16_blocks:
                forward_gate(tag, "lm_forward", lm_logits(s["prompt"]),
                             cfg, params, cfg32, params32, failures)
            tokens = torch.tensor([s["prompt"]], device="cuda")
            got, _ = lm_forward(params32, tokens, cfg32, True,
                                with_cache=False)
            want, _ = lm_forward(params32, tokens, cfg32, False,
                                 with_cache=False)
            _check_agreement(f"{cfg.name} float32 lm_forward logits, all "
                             f"{got.shape[1]} positions", got, want, failures)
            del got, want
        teacher_forced(cfg32, Model(cfg32, use_kernels=True),
                       Model(cfg32, use_kernels=False), params32,
                       specs[:SLOTS], seed, failures, gate_top1=True,
                       paged=paged)
        del params32
        free_card()
    ticks = {}
    for p in modes:
        label = "paged" if p else "dense"
        ticks[label] = _decode_tick(label, engine(cfg, params)(p), specs, tag)
        free_card()
    by_len = sorted(specs, key=lambda s: len(s["prompt"]))
    prefill_ms = {}
    for s in (by_len[0], by_len[len(by_len) // 2], by_len[-1]):
        tokens = torch.tensor([s["prompt"]], device="cuda")
        prefill_ms[tokens.shape[1]] = cuda_ms(
            lambda: model.prefill(params, {"tokens": tokens},
                                  cache_len=MAX_LEN + cfg.meta_tokens),
            iters=5)
        log(f"[{tag}] prefill {tokens.shape[1]} tokens (+ {cfg.meta_tokens} "
            f"meta; batch 1, eager, kernel route, median of 5): "
            f"{prefill_ms[tokens.shape[1]]:.3f} ms")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches, "ticks": ticks, "prefill_ms": prefill_ms}


def phase_dense_archs(seed: int) -> dict:
    """Llama-3.2-1B, MiniCPM-2B and GLM-4-9B at full width and depth, bf16,
    one after another: the op graph on its lanes (phase 3's gates), then
    the serve trace dense and paged (phase 6's gates; fp32 for Llama)."""
    out = {}
    for name in DENSE_ARCHS:
        tag = name.split("-")[0].replace(".", "")
        cfg, params = _init_full(tag, name, seed)
        graph = lm_graph_path(tag, cfg, params, seed, 800)
        specs = serve_specs(cfg.vocab_size, seed)
        by_len = sorted(specs, key=lambda s: len(s["prompt"]))
        serve = serve_arch(tag, cfg, params, seed, specs, paged=True,
                           fp32_serve=name in FP32_ARCHS,
                           prompts=[by_len[0], by_len[len(by_len) // 2],
                                    by_len[-1]],
                           bf16_blocks=name in BLOCK_GATED)
        out[name] = {"graph": graph["launches"], "serve": serve["launches"]}
        del params, graph, serve
        free_card()
    return out


def mamba_scan_share(tag: str, cfg, graph, replay_ms: float) -> None:
    """The Mamba scan's share of one op-graph replay (one layer's scan
    payload recorded alone into a CUDA graph, times the layers, over the
    lane graph's replay) and of an eager prefill (the scan alone at the
    prefill's length, times the layers, reported beside the prefills)."""
    from repro_torch.core.capture import CudaGraphReplay
    node = next(n for n in graph if n.name.endswith(".mamba_scan"))
    consts = node.meta["consts"]
    di, n = consts[0].shape
    g = torch.Generator(device="cuda").manual_seed(5)
    packed = (torch.randn((BATCH, SEQ, 2 * di + 2 * n + 1), generator=g,
                          device="cuda")).to(cfg.dtype)
    rep = CudaGraphReplay(lambda x: [node.fn(x, *consts)], [packed])
    nodes, _ = rep.kernel_dag()
    scan_ms = cuda_ms(rep.graph.replay)
    share = cfg.n_layers * scan_ms / replay_ms
    log(f"[{tag}] Mamba scan (one layer, seq {SEQ}, recorded alone: {nodes} "
        f"kernel nodes) {scan_ms:.3f} ms; x {cfg.n_layers} layers = "
        f"{cfg.n_layers * scan_ms:.3f} ms, {share:.3f} of the lane graph's "
        f"replay ({replay_ms:.3f} ms)")


def phase_hymba(seed: int) -> dict:
    """Hymba-1.5B at full width and depth: the op graph at seq 512 on its
    lanes beside its one-stream recording, the Mamba scan's share; the serve
    trace on the dense slab (bf16, fp32) plus one request whose 980-token
    prompt and 128 meta tokens cross the 1024-position window, whose
    windowed prefill and decode steps are held against the plain route."""
    from repro_torch.models.ssm import mamba_scan
    tag = "hymba"
    cfg, params = _init_full(tag, "hymba-1.5b", seed)
    if (cfg.window, cfg.meta_tokens) != (HYMBA_WINDOW, HYMBA_META):
        raise AssertionError("hymba's window or meta tokens moved")
    graph = lm_graph_path(tag, cfg, params, seed, 900)
    mamba_scan_share(tag, cfg, graph["graph"], graph["lanes"]["lanes_graph"])
    specs = serve_specs(cfg.vocab_size, seed)
    rng = np.random.default_rng(seed + 980)
    long_req = dict(rid=len(specs), arrival=0, priority=0, ttl=None,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        LONG_PROMPT).tolist())
    if LONG_PROMPT + cfg.meta_tokens <= cfg.window:
        raise AssertionError("the long request does not cross the window")
    by_len = sorted(specs, key=lambda s: len(s["prompt"]))
    # teacher-forced decode runs the first 8 specs: the long request is one
    trace = [long_req] + specs
    serve = serve_arch(tag, cfg, params, seed, trace, paged=False,
                       fp32_serve=True,
                       prompts=[by_len[0], by_len[-1], long_req],
                       bf16_blocks=True)
    # the scan's share of an eager prefill, at the prefills' lengths
    di, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
    a = -torch.exp(params["stacks"][0]["mamba"]["a_log"][0])
    for n_tok, prefill_ms in serve["prefill_ms"].items():
        t = n_tok + cfg.meta_tokens
        g = torch.Generator(device="cuda").manual_seed(t)
        args = (torch.rand((1, t, 1), generator=g, device="cuda") + 1e-4,
                torch.randn((1, t, di), generator=g, device="cuda"),
                torch.randn((1, t, n), generator=g, device="cuda"),
                torch.randn((1, t, n), generator=g, device="cuda"), a,
                torch.zeros((1, di, n), device="cuda"))
        scan_ms = cuda_ms(lambda: mamba_scan(*args), iters=5)
        log(f"[{tag}] prefill {n_tok} tokens: the Mamba scan alone (eager, "
            f"{t} positions) {scan_ms:.3f} ms x {cfg.n_layers} layers = "
            f"{cfg.n_layers * scan_ms / prefill_ms:.3f} of the prefill's "
            f"{prefill_ms:.3f} ms")
    return {"graph": graph["launches"], "serve": serve["launches"]}


# =============================================================================
# 13. whisper-medium
# =============================================================================

# Whisper's default sample length (n_text_ctx 448 / 2): the op graph's
# decoder tokens, and the facade's prompt plus its greedy ticks
WHISPER_DEC_SEQ, WHISPER_CACHE = 224, 448
# start of transcript, English, transcribe, no timestamps
WHISPER_PROMPT = (50258, 50259, 50359, 50363)
WHISPER_ROWS = 8                # audio segments of 1500 frames
WHISPER_TICKS = WHISPER_DEC_SEQ - len(WHISPER_PROMPT)
# fp32 kernel route vs plain route over the greedy streams: the routes
# differ in summation order only (flash and decode kernels vs the einsums)
FP32_LOGITS_REL_L2 = 1e-4


def whisper_frames(cfg, rows: int, seed: int, salt: int) -> torch.Tensor:
    fe = cfg.frontend
    g = torch.Generator(device="cuda").manual_seed(seed * 1000 + salt)
    return torch.randn((rows, fe.n_tokens, fe.feat_dim), generator=g,
                       device="cuda").to(cfg.dtype)


def whisper_graph(cfg, params, seed: int) -> dict:
    """The encoder-decoder op graph (1500 frames, 224 decoder tokens, batch
    1) with phase 3's gates: the 48 cross-attention K/V GEMMs read the
    encoder output alone, beside the decoder chain; the sequential CUDA
    Graph timed beside the plan on one stream and on its lanes."""
    from repro_torch.models.opgraph_export import build_encdec_opgraph
    t0 = time.perf_counter()
    graph = build_encdec_opgraph(cfg, batch=1, dec_seq=WHISPER_DEC_SEQ,
                                 params=params)
    cross = [n.op_id for n in graph
             if n.name.endswith((".cross_wk", ".cross_wv"))]
    log(f"[whisper] op graph: {len(graph)} ops, {len(cross)} cross-attention "
        f"K/V GEMMs of {cfg.frontend.n_tokens} rows on the encoder output, "
        f"export {time.perf_counter() - t0:.2f} s")

    def make(i):
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 1300 + i)
        fe = cfg.frontend
        return {"frames": torch.randn((1, fe.n_tokens, fe.feat_dim),
                                      generator=g, device="cuda").to(cfg.dtype),
                "tokens": torch.randint(0, cfg.vocab_size,
                                        (1, WHISPER_DEC_SEQ), generator=g,
                                        device="cuda")}

    def check(exe, recorded):
        # the route of every step holding a cross K/V GEMM
        steps = [(s.route, len(s.op_ids), s.lane) for s in exe.steps
                 if set(s.op_ids) & set(cross)]
        log(f"[whisper] cross K/V GEMMs in {len(steps)} steps (route, "
            f"branches, lane): {steps}")
        if sum(n for _, n, _ in steps) != len(cross):
            raise AssertionError("a cross K/V GEMM is in no step")

    out = op_graph_path("whisper", graph, make,
                        (1, WHISPER_DEC_SEQ, cfg.vocab_size), check=check)
    inputs, outs = out.pop("first")
    free_card()
    three_way("whisper", graph, inputs, outs[-1], out["lanes"])
    return out


def prefill_len(inputs: dict) -> int:
    """Positions a decoder prefill of ``inputs`` fills: the tokens, after
    the projected patch embeddings where there are any."""
    extra = inputs.get("extra_embeds")
    return inputs["tokens"].shape[1] + (0 if extra is None
                                        else extra.shape[1])


def facade_greedy(model, params, inputs: dict, ticks: int, record: bool,
                  cache_len: int) -> dict:
    """Prefill (``cache_len``), then ``ticks`` greedy decode ticks, each
    tick eager or (``record``) a replay of one CUDA graph of the step
    recorded at the first tick.  Returns the token streams [rows, 1 +
    ticks], each step's logits, the caches, the replay and the ticks' host
    time."""
    from repro_torch.core.capture import CudaGraphReplay
    logits, caches = model.prefill(params, inputs, cache_len=cache_len)
    tok = logits.argmax(-1)
    pos = torch.full((tok.shape[0],), prefill_len(inputs), dtype=torch.int32,
                     device="cuda")
    steps, out = [tok], [logits]
    replay = None

    def tick(token, p):
        return [model.decode(params, token, caches, p)[0]]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        if record and replay is None:
            replay = CudaGraphReplay(tick, [tok, pos])
        logits = replay([tok, pos])[0] if record else tick(tok, pos)[0]
        tok = logits.argmax(-1)
        pos = pos + 1
        steps.append(tok)
        out.append(logits)
    torch.cuda.synchronize()
    return {"tokens": torch.stack(steps, 1), "logits": out, "caches": caches,
            "replay": replay, "tick": tick, "last": (tok, pos - 1),
            "seconds": time.perf_counter() - t0}


def whisper_blocks(cfg, params, frames, tokens) -> tuple:
    """``block_gate``'s input and blocks for the decoder: the embedded
    ``tokens``, each decoder block's pass over them (its cross-attention on
    the encoded ``frames``) and its decode step after them.  The encoder
    runs the same code on both routes (no kernel)."""
    from repro_torch.models import encdec
    from repro_torch.models.layers import embed
    from repro_torch.models.transformer import layer_params
    enc = encdec.encode(params, frames, cfg)
    b, s = tokens.shape
    x = embed(params["embed"], tokens) + params["dec_pos"][None, :s]
    positions = torch.arange(s, device="cuda")[None].expand(b, s)
    pos = torch.full((b,), s, dtype=torch.int32, device="cuda")

    def block(p):
        def seq(h, route):
            return encdec.decoder_block_seq(p, h, enc, cfg, positions, route)

        def step(h, cache, route):
            self_kv, ckv = cache
            return encdec.decoder_block_step(p, h, (_one_longer(self_kv), ckv),
                                             pos, cfg, route)[0]
        return seq, step

    return x, [block(layer_params(params["dec_blocks"], li))
               for li in range(cfg.n_dec_layers)]


def facade_truth(cfg32, params32, inputs32: dict, stream: torch.Tensor,
                 cache_len: int) -> dict:
    """``facade_route_gate``'s reference for a deep bf16 model: the fp32
    plain route at the facade's shapes, its prefill (last-token logits, K/V
    over the prefill) and its ticks from its own caches, fed the tokens of
    ``stream``."""
    from repro_torch.models import Model
    plain = Model(cfg32, use_kernels=False)
    s = prefill_len(inputs32)
    logits, caches = plain.prefill(params32, inputs32, cache_len=cache_len)
    out = {"logits": [logits],
           "kv": [c[:, :, :s].clone() for c in caches[0]]}
    for t in range(stream.shape[1] - 1):
        pos = torch.full((stream.shape[0],), s + t, dtype=torch.int32,
                         device="cuda")
        out["logits"].append(plain.decode(params32, stream[:, t], caches,
                                          pos)[0])
    return out


def facade_route_gate(tag: str, cfg, params, inputs: dict, run: dict,
                      cache_len: int, failures: list,
                      limit: float = LOGITS_REL_L2,
                      truth: dict | None = None) -> None:
    """Kernel route vs plain route at the facade's own shapes: the prefill
    by its last-token logits and its (self) K/V over the prefill; then
    every tick of ``run`` (a :func:`facade_greedy` run with a recorded
    graph), from copies of the kernel prefill's caches and fed the same
    tokens (the run's stream), the kernel route through the run's recorded
    CUDA graph, the plain route eagerly.  Relative L2 <= ``limit`` at each;
    with ``truth`` (:func:`facade_truth`, the fp32 plain route) each is
    held by ``forward_gate``'s rule instead: the kernel route's distance
    from fp32 within max(``limit``, 1.25 x the plain route's), the two
    routes' distance from each other reported.  Also reports the first step
    at which the plain route's greedy choice leaves the stream (before it
    both routes' free-running greedy streams are the same, so it is where
    they part); in fp32 it must never."""
    from repro_torch.models import Model
    s = prefill_len(inputs)
    logits_k, caches = Model(cfg, use_kernels=True).prefill(
        params, inputs, cache_len=cache_len)
    plain = Model(cfg, use_kernels=False)
    logits_p, caches_p = plain.prefill(params, inputs, cache_len=cache_len)
    # the worst reading at each point: kernel vs plain route, and with
    # truth the kernel's and the plain route's distances from fp32 where
    # the kernel's is furthest over its limit
    worst = {name: {"pair": 0.0, "kernel": 0.0, "plain": 0.0, "limit": limit,
                    "over": 0.0} for name in ("prefill", "K/V", "tick")}

    def judge(name, got, want, key, i):
        w = worst[name]
        w["pair"] = max(w["pair"], _agreement(got, want)[0])
        if truth is None:
            w["kernel"], w["over"] = w["pair"], w["pair"] / limit
            return
        ref = truth[key][i]
        rel_k, rel_p = _agreement(got, ref)[0], _agreement(want, ref)[0]
        lim = max(limit, 1.25 * rel_p)
        if rel_k / lim >= w["over"]:
            w.update(kernel=rel_k, plain=rel_p, limit=lim, over=rel_k / lim)

    judge("prefill", logits_k, logits_p, "logits", 0)
    for i, (a, b) in enumerate(zip(caches[0], caches_p[0])):
        judge("K/V", a[:, :, :s], b[:, :, :s], "kv", i)
    del caches_p
    # the recorded graph reads and writes the run's caches: reset them to
    # the kernel prefill's, which the plain route then takes as its own
    for dst, src in zip(_param_leaves(run["caches"]), _param_leaves(caches)):
        dst.copy_(src)
    stream = run["tokens"]
    parted = None
    if not torch.equal(logits_p.argmax(-1), stream[:, 0]):
        parted = 0
    for t in range(stream.shape[1] - 1):
        tok = stream[:, t]
        pos = torch.full_like(run["last"][1], s + t)
        got = run["replay"]([tok, pos])[0]
        want = plain.decode(params, tok, caches, pos)[0]
        judge("tick", got, want, "logits", t + 1)
        if parted is None and not torch.equal(want.argmax(-1),
                                              stream[:, t + 1]):
            parted = t + 1
    fp32 = cfg.dtype == torch.float32
    shapes = (f"prefill ({stream.shape[0]} rows x {s} positions, cache "
              f"{cache_len}) last-token logits, K/V over the prefill, "
              f"{stream.shape[1] - 1} ticks from the same caches fed the "
              f"same tokens (graph vs eager)")
    if truth is None:
        log(f"[{tag}] {_dt(cfg.dtype)} facade, kernel route vs plain route "
            f"at the path's shapes: {shapes}: rel_l2 prefill "
            f"{worst['prefill']['pair']:.3e}, K/V {worst['K/V']['pair']:.3e}"
            f", worst tick {worst['tick']['pair']:.3e} (all <= {limit})")
    else:
        log(f"[{tag}] {_dt(cfg.dtype)} facade against the fp32 plain route "
            f"(its own prefill and ticks on the same tokens) at the path's "
            f"shapes: {shapes}: kernel route rel_l2 / plain route rel_l2 "
            f"(limit max({limit}, 1.25 x plain)) "
            + ", ".join(f"{name} {w['kernel']:.3e} / {w['plain']:.3e} (<= "
                        f"{w['limit']:.3e})" for name, w in worst.items())
            + "; kernel vs plain route rel_l2 (reported) "
            + ", ".join(f"{name} {w['pair']:.3e}"
                        for name, w in worst.items()))
    log(f"[{tag}] {_dt(cfg.dtype)} facade: the plain route's greedy choice "
        f"first leaves the stream at step {parted} (0 = the prefill's token,"
        f" None = never" + ("; must be None in fp32)" if fp32 else ")"))
    if (max(w["over"] for w in worst.values()) > 1.0
            or (fp32 and parted is not None)):
        failures.append(f"{tag} {_dt(cfg.dtype)} facade kernel route: "
                        + ", ".join(f"{name} rel_l2 {w['kernel']:.3e} (<= "
                                    f"{w['limit']:.3e})"
                                    for name, w in worst.items())
                        + f", parted at {parted}")


def cross_attention_share(cfg, params, caches, tick_ms: float) -> None:
    """The plain cross-attention (``_sdpa`` of one query over each decoder
    layer's 1500-position K/V, the wq / wo GEMMs left out) of one tick,
    recorded alone into a CUDA graph, against the tick's graph time; beside
    it the bytes the fp32 casts move."""
    from repro_torch.core.capture import CudaGraphReplay
    from repro_torch.core.profiler import detect_hardware
    from repro_torch.models.attention import _sdpa
    from repro_torch.models.transformer import _layer_cache
    ckv = caches[1]
    rows = ckv[0].shape[1]
    g = torch.Generator(device="cuda").manual_seed(13)
    q = torch.randn((rows, 1, cfg.n_heads, cfg.head_dim), generator=g,
                    device="cuda").to(cfg.dtype)

    def attend(query):
        return [_sdpa(query, *_layer_cache(ckv, li), None)
                for li in range(cfg.n_dec_layers)]

    rep = CudaGraphReplay(attend, [q])
    ms = cuda_ms(rep.graph.replay)
    # each layer reads K and V in bf16, writes them in fp32 and reads the
    # fp32 copies back in the einsums
    kv_elems = 2 * ckv[0][0].numel()
    est_bytes = cfg.n_dec_layers * kv_elems * (2 + 4 + 4)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _param_leaves(params["dec_blocks"]))
    table = params["embed"]["table"]
    weight_bytes += table.numel() * table.element_size()
    hw = detect_hardware()
    log(f"[whisper] plain cross-attention of a tick ({cfg.n_dec_layers} "
        f"layers x {rows} rows x {ckv[0].shape[2]} positions, recorded "
        f"alone) {ms:.3f} ms, {ms / tick_ms:.3f} of the tick graph's "
        f"{tick_ms:.3f} ms; from the code, its fp32 casts move "
        f"{est_bytes / 1e9:.2f} GB a tick ({est_bytes / hw.hbm_bw * 1e3:.3f} "
        f"ms at {hw.hbm_bw / 1e12:.2f} TB/s) against the tick's "
        f"{weight_bytes / 1e9:.2f} GB of "
        f"decoder and head weights")


def whisper_facade(cfg, params, seed: int) -> dict:
    """The facade at 8 segments of 1500 frames: the Whisper prompt, prefill
    (cache 448), 220 greedy ticks through one CUDA graph of the decode
    step; the graph tick bit-equal to the eager tick; every bf16 flash
    launch on wgmma and decode launch on mma; kernel route vs plain route
    (fp32: equal streams, logits within 1e-4; bf16: each decoder block on
    identical inputs, the prefill and every tick at the path's shapes, the
    whole model against the fp32 plain route); times of encode, prefill and
    the tick, tokens/s, the cross-attention's share of a tick."""
    from repro_torch.models import Model, encdec
    frames = whisper_frames(cfg, WHISPER_ROWS, seed, 1400)
    prompt = torch.tensor([WHISPER_PROMPT] * WHISPER_ROWS, device="cuda")
    inputs = {"frames": frames, "tokens": prompt}
    model = Model(cfg, use_kernels=True)
    # -- the facade's run: launch counts from 0 ----------------------------------
    reset_launches()
    run = facade_greedy(model, params, inputs, WHISPER_TICKS, record=True,
                        cache_len=WHISPER_CACHE)
    launches = read_launches("flash_attention", "decode_attention")
    check_flash_wgmma_only("whisper")
    check_decode_mma_only("whisper", paged=False)
    # -- end of the facade's run ---------------------------------------------------
    replay = run["replay"]
    log(f"[whisper] facade: {WHISPER_ROWS} rows x {cfg.frontend.n_tokens} "
        f"frames, prompt {list(WHISPER_PROMPT)}, {WHISPER_TICKS} greedy "
        f"ticks through one CUDA graph of the decode step ({replay.n_lanes} "
        f"stream, launches recorded {replay.recorded_launches}); wrapper "
        f"launches over the run {launches}; "
        f"{WHISPER_ROWS * WHISPER_TICKS / run['seconds']:.1f} tokens/s over "
        f"the ticks ({run['seconds']:.3f} s, host clock, the recording "
        f"included)")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the Whisper facade launched no {name}")
    streams = run["tokens"]
    if tuple(streams.shape) != (WHISPER_ROWS, 1 + WHISPER_TICKS) or not all(
            bool(torch.isfinite(x).all()) for x in run["logits"]):
        raise AssertionError(f"bad streams {tuple(streams.shape)} or logits")
    # the graph tick against the eager tick at the last position (the
    # self K/V write there is idempotent)
    tok, pos = run["last"]
    graph_logits = replay([tok, pos])[0]
    eager_logits = run["tick"](tok, pos)[0]
    if not torch.equal(graph_logits, eager_logits):
        raise AssertionError("whisper: CUDA-graph decode tick differs from "
                             "the eager tick")
    graph_ms = cuda_ms(lambda: replay([tok, pos]))
    eager_ms = cuda_ms(lambda: run["tick"](tok, pos), iters=10)
    encode_ms = cuda_ms(lambda: encdec.encode(params, frames, cfg), iters=5)
    prefill_ms = cuda_ms(lambda: model.prefill(params, inputs,
                                               cache_len=WHISPER_CACHE),
                         iters=5)
    log(f"[whisper] encode {encode_ms:.3f} ms, prefill (encode + 4-token "
        f"decoder pass) {prefill_ms:.3f} ms (median of 5); decode tick at "
        f"{WHISPER_ROWS} rows: CUDA-graph replay {graph_ms:.3f} ms (host "
        f"copies included), eager {eager_ms:.3f} ms; graph logits bit-equal "
        f"to eager")
    profile_replay(lambda: replay([tok, pos]), n=5,
                   what="decode tick (graph)", tag="whisper-profile")
    cross_attention_share(cfg, params, run["caches"], graph_ms)
    failures: list[str] = []
    # bf16: the facade's prefill and ticks at the path's own shapes, each
    # decoder block on identical inputs, then the whole model against the
    # fp32 plain route beside the bf16 plain route, both over the prompt
    # and the kernel route's greedy tokens (224 positions)
    facade_route_gate("whisper", cfg, params, inputs, run, WHISPER_CACHE,
                      failures)
    forced = torch.cat([prompt, streams[:, :-1]], dim=1)
    block_gate("whisper", "bf16 decoder (the encoder has no kernel)",
               *whisper_blocks(cfg, params, frames, forced), failures)
    del run, replay
    free_card()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = _cast(params, torch.float32)
    frames32 = frames.float()

    def logits(p, c, use_kernels):
        enc = encdec.encode(p, frames.to(c.dtype), c)
        return encdec.decode_seq(p, forced, enc, c, use_kernels)[0]

    forward_gate("whisper", "encode + decode_seq", logits, cfg, params, cfg32,
                 params32, failures)
    free_card()
    # fp32: the kernel route's greedy streams (graph ticks) equal the plain
    # route's (eager ticks), logits within 1e-4 at every step
    inputs32 = {"frames": frames32, "tokens": prompt}
    runs = [facade_greedy(Model(cfg32, use_kernels=k), params32, inputs32,
                          WHISPER_TICKS, record=k, cache_len=WHISPER_CACHE)
            for k in (True, False)]
    same = torch.equal(runs[0]["tokens"], runs[1]["tokens"])
    worst = max(_agreement(a, b)[0] for a, b in zip(runs[0]["logits"],
                                                     runs[1]["logits"]))
    log(f"[whisper] fp32 greedy streams, kernel route (graph ticks) vs plain "
        f"route (eager): {WHISPER_ROWS} streams of {1 + WHISPER_TICKS} tokens "
        f"identical {same}; worst step logits rel_l2 {worst:.3e} (<= "
        f"{FP32_LOGITS_REL_L2})")
    if not same or worst > FP32_LOGITS_REL_L2:
        failures.append(f"whisper fp32 kernel route: streams identical "
                        f"{same}, rel_l2 {worst:.3e}")
    del runs, params32
    free_card()
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches, "graph_ms": graph_ms,
            "prefill_ms": prefill_ms}


def phase_whisper(seed: int) -> dict:
    """Whisper-medium at full width and depth (24 + 24 layers, bf16): the
    op graph (phase 3's gates, the sequential CUDA Graph beside it), then
    the model facade."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("whisper-medium")
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(seed),
                             "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _param_leaves(params))
    log(f"[whisper] {cfg.name}: {cfg.n_layers} encoder + {cfg.n_dec_layers} "
        f"decoder layers d={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} vocab="
        f"{cfg.vocab_size} frames={cfg.frontend.n_tokens} {_dt(cfg.dtype)}: "
        f"{n_params / 1e9:.3f} B params (dec_pos {cfg.max_seq_len} rows), "
        f"init {time.perf_counter() - t0:.2f} s")
    graph = whisper_graph(cfg, params, seed)
    free_card()
    facade = whisper_facade(cfg, params, seed)
    return {"graph": graph["launches"], "facade": facade["launches"]}


# =============================================================================
# 14. llava-next-mistral-7b
# =============================================================================

def llava_inputs(cfg, seed: int) -> dict:
    """The facade's multimodal batch from the seed: 4 rows of 2880 anyres
    patch embeddings (the vision tower is the reference's stub) and a
    64-token question each."""
    fe = cfg.frontend
    g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 1500)
    return {"extra_embeds": torch.randn(
                (LLAVA_ROWS, fe.n_tokens, fe.feat_dim), generator=g,
                device="cuda").to(cfg.dtype),
            "tokens": torch.randint(1, cfg.vocab_size,
                                    (LLAVA_ROWS, LLAVA_PROMPT), generator=g,
                                    device="cuda")}


def llava_facade(cfg, params, seed: int) -> dict:
    """The facade at 4 rows of 2880 patches + 64 tokens (2944 positions,
    cache 2976): prefill, then 32 greedy ticks through one CUDA graph of
    the decode step; the graph tick bit-equal to the eager tick; every bf16
    flash launch (S = 2944) on wgmma and decode launch on mma; kernel route
    vs plain route (``chunked_attention`` past 2048 positions) at the
    path's shapes (the prefill and every tick from the same caches fed the
    same tokens), each route held against the fp32 plain route by
    ``forward_gate``'s rule; each block on identical inputs, the whole
    model against the fp32 plain route; in fp32 the kernel route against
    the plain route with the greedy choices never parting; prefill (both routes) and tick times, the
    tick's and the prefill's idle shares."""
    from repro_torch.models import Model
    from repro_torch.models.attention import CHUNK_THRESHOLD
    from repro_torch.models.transformer import lm_forward
    inputs = llava_inputs(cfg, seed)
    s = prefill_len(inputs)
    cache_len = s + LLAVA_TICKS
    if s != LLAVA_S or s * s <= CHUNK_THRESHOLD:
        raise AssertionError(f"llava's prefill of {s} positions is not past "
                             "the chunked threshold")
    model = Model(cfg, use_kernels=True)
    # -- the facade's run: launch counts from 0 ----------------------------------
    reset_launches()
    run = facade_greedy(model, params, inputs, LLAVA_TICKS, record=True,
                        cache_len=cache_len)
    launches = read_launches("rmsnorm", "flash_attention", "decode_attention")
    check_flash_wgmma_only("llava")
    check_decode_mma_only("llava", paged=False)
    # -- end of the facade's run ---------------------------------------------------
    replay = run["replay"]
    log(f"[llava] facade: {LLAVA_ROWS} rows x ({LLAVA_PATCHES} patches + "
        f"{LLAVA_PROMPT} tokens), {LLAVA_TICKS} greedy ticks through one "
        f"CUDA graph of the decode step (launches recorded "
        f"{replay.recorded_launches}); wrapper launches over the run "
        f"{launches}; {LLAVA_ROWS * LLAVA_TICKS / run['seconds']:.1f} "
        f"tokens/s over the ticks ({run['seconds']:.3f} s, host clock, the "
        f"recording included)")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the llava facade launched no {name}")
    streams = run["tokens"]
    if tuple(streams.shape) != (LLAVA_ROWS, 1 + LLAVA_TICKS) or not all(
            bool(torch.isfinite(x).all()) for x in run["logits"]):
        raise AssertionError(f"bad streams {tuple(streams.shape)} or logits")
    # the graph tick against the eager tick at the last position (the K/V
    # write there is idempotent)
    tok, pos = run["last"]
    if not torch.equal(replay([tok, pos])[0], run["tick"](tok, pos)[0]):
        raise AssertionError("llava: CUDA-graph decode tick differs from the "
                             "eager tick")
    tick_ms = cuda_ms(lambda: replay([tok, pos]))
    eager_ms = cuda_ms(lambda: run["tick"](tok, pos), iters=10)
    plain = Model(cfg, use_kernels=False)
    prefill_ms = {name: cuda_ms(lambda m=m: m.prefill(
        params, inputs, cache_len=cache_len), iters=3, warmup=1)
        for name, m in (("kernel", model), ("plain", plain))}
    log(f"[llava] prefill {LLAVA_ROWS} x {s} positions (eager, median of "
        f"3): kernel route (flash) {prefill_ms['kernel']:.3f} ms, plain "
        f"route (chunked_attention) {prefill_ms['plain']:.3f} ms; decode "
        f"tick at {LLAVA_ROWS} rows over {s}.. positions: CUDA-graph replay "
        f"{tick_ms:.3f} ms (host copies included), eager {eager_ms:.3f} ms; "
        f"graph logits bit-equal to eager")
    profile_replay(lambda: replay([tok, pos]), n=5,
                   what="decode tick (graph)", tag="llava-profile")
    profile_replay(lambda: model.prefill(params, inputs, cache_len=cache_len),
                   n=2, what="prefill (eager, kernel route)",
                   tag="llava-profile-prefill")
    failures: list[str] = []
    # the prefill and every tick at the path's shapes, each route against
    # the fp32 plain route (a 32-layer bf16 model's two routes sit about as
    # far from each other as each from fp32, ROADMAP C8)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = _cast(params, torch.float32)
    inputs32 = {"extra_embeds": inputs["extra_embeds"].float(),
                "tokens": inputs["tokens"]}
    truth = facade_truth(cfg32, params32, inputs32, streams, cache_len)
    free_card()
    facade_route_gate("llava", cfg, params, inputs, run, cache_len, failures,
                      truth=truth)
    del truth
    free_card()
    # each block on identical inputs, then the whole model against the fp32
    # plain route beside the bf16 plain route, over the images, the
    # questions and the kernel route's greedy tokens (2976 positions)
    forced = torch.cat([inputs["tokens"], streams[:, :-1]], dim=1)
    block_gate("llava", _dt(cfg.dtype),
               *lm_blocks(cfg, params, forced, inputs["extra_embeds"]),
               failures)
    del run, replay
    free_card()

    def logits(p, c, use_kernels):
        return lm_forward(p, forced, c, use_kernels, with_cache=False,
                          extra_embeds=inputs["extra_embeds"].to(c.dtype))[0]

    forward_gate("llava", "lm_forward with the images", logits, cfg, params,
                 cfg32, params32, failures)
    free_card()
    # fp32 at full depth: the kernel route's greedy run (graph ticks)
    # against the plain route from the same caches on the same tokens
    run32 = facade_greedy(Model(cfg32, use_kernels=True), params32, inputs32,
                          LLAVA_TICKS, record=True, cache_len=cache_len)
    facade_route_gate("llava", cfg32, params32, inputs32, run32, cache_len,
                      failures, limit=FP32_LOGITS_REL_L2)
    del run32, params32
    free_card()
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches, "tick_ms": tick_ms,
            "prefill_ms": prefill_ms}


def phase_llava(seed: int) -> dict:
    """llava-next-mistral-7b at full width and depth (32 layers, bf16): the
    op graph with phase 3's gates and the sequential CUDA Graph beside it
    (text, batch 1, seq 512: the export has no frontend nodes, as the
    reference's), the multimodal facade, then phase 6's serve trace on
    dense and paged engines (text prompts, as the reference's engine
    serves), held as GLM-4's."""
    tag = "llava"
    cfg, params = _init_full(tag, "llava-next-mistral-7b", seed)
    if ((cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) != LLAVA_HEADS
            or cfg.frontend.n_tokens != LLAVA_PATCHES):
        raise AssertionError("llava's heads or patch count moved")
    graph = lm_graph_path(tag, cfg, params, seed, 1500)
    inputs, outs = graph.pop("first")
    free_card()
    three_way(tag, graph["graph"], inputs, outs[-1], graph["lanes"])
    del inputs, outs
    graph.pop("graph")
    free_card()
    facade = llava_facade(cfg, params, seed)
    free_card()
    specs = serve_specs(cfg.vocab_size, seed)
    by_len = sorted(specs, key=lambda s: len(s["prompt"]))
    serve = serve_arch(tag, cfg, params, seed, specs, paged=True,
                       fp32_serve=False,
                       prompts=[by_len[0], by_len[len(by_len) // 2],
                                by_len[-1]],
                       bf16_blocks=True)
    return {"graph": graph["launches"], "facade": facade["launches"],
            "serve": serve["launches"]}


# =============================================================================
# 15. training
# =============================================================================

# chunked_attention's backward past 2048 positions: S = T = 2304 in chunks
# of 2048 (the last one short), at Qwen2-0.5B's, llava's and MLA's heads
CHUNK_S, CHUNK = 2304, 2048
CHUNK_HEADS = (("qwen2 14/2x64", 14, 2, 64, 64),
               ("llava 32/8x128", 32, 8, 128, 128),
               ("mla 128/1x576/512", 128, 1, 576, 512))
# the reference's grad tolerance for chunked_attention against the naive
# route (tests/test_kernels.py), fp32; bf16 by relative L2
CHUNK_GRAD_TOL = 1e-4
CHUNK_GRAD_REL_L2 = 2e-2
# Qwen2-0.5B at full width: one fp32 step on the card against the same step
# on the card machine's CPU (2 layers, batch 2, seq 256), then the trainer
# at full depth (batch 8, seq 512, 30 steps, bf16 params, fp32 moments),
# one step past 2048 positions (batch 1, seq 2304) and a restart (2
# layers, 12 steps with a checkpoint every 6, resumed to 18, against 18
# uninterrupted steps)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 30, 8, 512
TRAIN_TIMED = slice(10, 30)
RESTART_BATCH, RESTART_SEQ = 4, 256
# the reference's restart rule (tests/test_system.py)
RESTART_TOL = 5e-3
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_ckpt")


def chunked_backward_checks(gen: torch.Generator) -> None:
    """chunked_attention's flash backward against the autograd of _sdpa on
    the same inputs and output grads, causal at S = T = 2304: each route's
    forward + backward time and peak memory."""
    from repro_torch.models.attention import (_sdpa, causal_window_mask,
                                              chunked_attention)
    s = CHUNK_S
    pos = torch.arange(s, device="cuda")
    mask = causal_window_mask(pos, pos, None)
    routes = {
        "chunked": lambda q, k, v: chunked_attention(
            q, k, v, causal=True, q_chunk=CHUNK, kv_chunk=CHUNK),
        "sdpa": lambda q, k, v: _sdpa(q, k, v, mask)}
    for label, h, kvh, dk, dv in CHUNK_HEADS:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = (
                torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in ((1, s, h, dk), (1, s, kvh, dk),
                              (1, s, kvh, dv), (1, s, h, dv)))
            grads, info = {}, {}
            for name, fn in routes.items():
                def fwd_bwd(fn=fn):
                    tq, tk, tv = (t.detach().requires_grad_(True)
                                  for t in (q, k, v))
                    return torch.autograd.grad(fn(tq, tk, tv), (tq, tk, tv),
                                               dout)
                free_card()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                grads[name] = fwd_bwd()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                info[name] = (cuda_ms(fwd_bwd, iters=3, warmup=1), peak)
            errs = []
            for got, want, what in zip(grads["chunked"], grads["sdpa"],
                                       ("dq", "dk", "dv")):
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"[train-chunked] {label} "
                                         f"{_dt(dtype)} {what} not finite")
                if dtype == torch.float32:
                    err = (got - want).abs()
                    errs.append(f"{what} max|err| {float(err.max()):.3e}")
                    if bool((err > CHUNK_GRAD_TOL
                             + CHUNK_GRAD_TOL * want.abs()).any()):
                        raise AssertionError(
                            f"[train-chunked] {label} fp32 {what} past "
                            f"rtol = atol = {CHUNK_GRAD_TOL}")
                else:
                    rel = _agreement(got, want)[0]
                    errs.append(f"{what} rel_l2 {rel:.3e}")
                    if not rel <= CHUNK_GRAD_REL_L2:
                        raise AssertionError(
                            f"[train-chunked] {label} bf16 {what} rel_l2 "
                            f"{rel:.3e} > {CHUNK_GRAD_REL_L2}")
            log(f"[train-chunked] {label} {_dt(dtype)} S=T={s} chunks of "
                f"{CHUNK}: {', '.join(errs)}; forward+backward chunked "
                f"{info['chunked'][0]:.3f} ms peak "
                f"{info['chunked'][1] / 2**20:.0f} MiB, _sdpa "
                f"{info['sdpa'][0]:.3f} ms peak "
                f"{info['sdpa'][1] / 2**20:.0f} MiB (median of 3)")
            del q, k, v, dout, grads
    free_card()


def fp32_step_card_vs_cpu(seed: int) -> None:
    """One fp32 train step of full-width Qwen2-0.5B cut to 2 layers, from
    the same params and batch, on the card and on this machine's CPU."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data import make_dataset
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    from repro_torch.utils.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2,
                              dtype=torch.float32)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in
             make_dataset(cfg.vocab_size, 256, 2).batch_at(0).items()}
    step = make_train_step(model, ParallelConfig(remat="none"),
                           base_lr=1e-3, warmup=0, total_steps=10)
    runs = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, _, grads = loss_and_grads(model, p, b, seed)
        new, _, _ = step(p, adamw_init(p), b, seed)
        runs[dev] = (float(loss), [t.cpu() for t in tree_leaves(grads)],
                     [t.cpu() for t in tree_leaves(new)])
        log(f"[train-fp32] {dev}: loss {float(loss):.6f}, loss+grads and "
            f"one step {time.perf_counter() - t0:.2f} s")
        del p, b, grads, new
    (l_cpu, g_cpu, p_cpu), (l_gpu, g_gpu, p_gpu) = runs["cpu"], runs["cuda"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel = max(_agreement(a, b)[0] for a, b in zip(g_gpu, g_cpu))
    # the new params as one vector: a leaf that starts at zero (Qwen2's
    # q/k/v biases) holds just AdamW's first update, lr·g/(|g|+eps), whose
    # entries with grads near eps carry the grads' last bits, so that
    # leaf's own relative error is reported beside the gate
    param_rel = _agreement(torch.cat([t.reshape(-1) for t in p_gpu]),
                           torch.cat([t.reshape(-1) for t in p_cpu]))[0]
    leaf_rel = max(_agreement(a, b)[0] for a, b in zip(p_gpu, p_cpu))
    log(f"[train-fp32] {cfg.name} d={cfg.d_model} 2 layers fp32 batch 2 seq "
        f"256, card vs CPU: loss rel {loss_rel:.3e} (<= 1e-5), worst grad "
        f"leaf rel_l2 {grad_rel:.3e} (<= 1e-4), new params rel_l2 "
        f"{param_rel:.3e} (<= 1e-5; worst leaf {leaf_rel:.3e})")
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4 and param_rel <= 1e-5):
        raise AssertionError("[train-fp32] the card's step disagrees with "
                             "the CPU's")
    del runs, params
    free_card()


def profile_train_step(seed: int) -> None:
    """The idle share of one full-depth bf16 train step (batch 8, seq 512)
    from torch.profiler: device busy as the union of kernel intervals
    against the step's wall time, and the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data import make_dataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    cfg = get_config("qwen2-0.5b")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        "cuda")
    opt = adamw_init(params)
    step = make_train_step(model, ParallelConfig(remat="none"),
                           base_lr=1e-3, warmup=10, total_steps=1000)
    data = make_dataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)

    def one(i):
        batch = {k: torch.from_numpy(v).to("cuda", torch.long)
                 for k, v in data.batch_at(i).items()}
        return step(params, opt, batch, i)
    for i in range(2):
        params, opt, metrics = one(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, metrics = one(2)
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("[train-profile] torch.profiler recorded no device time")
        return
    busy_us, _ = busy_and_overlap([(e.time_range.start, e.time_range.end)
                                   for e in kernels])
    busy = busy_us / 1e3
    log(f"[train-profile] one full-depth bf16 step (batch {TRAIN_BATCH}, seq "
        f"{TRAIN_SEQ}): device busy {busy:.3f} ms of wall {wall_ms:.3f} ms "
        f"(idle share {max(0.0, 1 - busy / wall_ms):.3f}), "
        f"{len(kernels)} device events")
    rows: dict = {}
    for e in kernels:
        ms, n = rows.get(e.name, (0.0, 0))
        rows[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                        n + 1)
    for name, (ms, n) in sorted(rows.items(), key=lambda r: -r[1][0])[:10]:
        log(f"[train-profile] {ms:8.3f} ms {n:5d}x  {name[:90]}")
    del params, opt
    free_card()


def phase_training(env: dict, gen: torch.Generator, seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import attention

    chunked_backward_checks(gen)
    fp32_step_card_vs_cpu(seed)

    # -- the slice: the trainer at full width and depth ------------------------
    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    res = train("qwen2-0.5b", smoke=False, steps=TRAIN_STEPS,
                batch=TRAIN_BATCH, seq=TRAIN_SEQ, ckpt_dir=None, resume=False,
                log_every=10, device="cuda")
    wall_s = time.perf_counter() - t0
    losses, norms = res["losses"], res["grad_norms"]
    if len(losses) != TRAIN_STEPS or not all(
            np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"[train] a loss or grad norm is not finite: "
                             f"{losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[train] the loss did not fall: {losses}")
    n_params = res["n_params"]
    free_card()
    step_ms = statistics.median(res["step_ms"][TRAIN_TIMED])
    fb_ms = statistics.median(res["fwd_bwd_ms"][TRAIN_TIMED])
    opt_ms = statistics.median(res["opt_ms"][TRAIN_TIMED])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * n_params * tokens
    peak = env["hw"].peak_flops
    log(f"[train] {cfg.name} full width and depth ({cfg.n_layers} layers, "
        f"d={cfg.d_model}, vocab {cfg.vocab_size}, {n_params / 1e6:.1f} M "
        f"params, {_dt(cfg.dtype)} params, fp32 moments), batch "
        f"{TRAIN_BATCH} seq {TRAIN_SEQ}, {TRAIN_STEPS} steps in {wall_s:.1f} "
        f"s: loss {losses[0]:.4f} -> {losses[-1]:.4f}, grad norm "
        f"{norms[0]:.3f} -> {norms[-1]:.3f}")
    log(f"[train] step ms over steps 10-29 (CUDA events, median): "
        f"{step_ms:.3f} (forward+backward {fb_ms:.3f}, optimizer "
        f"{opt_ms:.3f}); mean "
        f"{statistics.mean(res['step_ms'][TRAIN_TIMED]):.3f}; "
        f"{tokens / step_ms * 1e3:.0f} training tokens/s; peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB; 6*N*tokens "
        f"{flops / 1e12:.2f} TFLOP a step, bound {flops / peak * 1e3:.3f} "
        f"ms at {peak / 1e12:.0f} TFLOP/s, model-FLOP share "
        f"{flops / peak / (step_ms / 1e3):.3f}")
    profile_train_step(seed)

    # -- one step past 2048 positions: chunked_attention in the model ----------
    calls = {"bwd": 0}
    flash_bwd = attention._flash_bwd

    def counted(*args, **kwargs):
        calls["bwd"] += 1
        return flash_bwd(*args, **kwargs)
    attention._flash_bwd = counted
    try:
        long = train("qwen2-0.5b", smoke=False, steps=1, batch=1,
                     seq=CHUNK_S, ckpt_dir=None, resume=False,
                     log_every=10, device="cuda")
    finally:
        attention._flash_bwd = flash_bwd
    if not (np.isfinite(long["losses"][0])
            and np.isfinite(long["grad_norms"][0])):
        raise AssertionError(f"[train-long] not finite: {long['losses']} "
                             f"{long['grad_norms']}")
    if calls["bwd"] != cfg.n_layers:
        raise AssertionError(f"[train-long] chunked backward ran "
                             f"{calls['bwd']} times, {cfg.n_layers} layers")
    log(f"[train-long] batch 1 seq {CHUNK_S}, full depth: loss "
        f"{long['losses'][0]:.4f}, grad norm {long['grad_norms'][0]:.3f} "
        f"(finite, so every grad is), chunked backward in "
        f"{calls['bwd']} layers; the step {long['step_ms'][0]:.3f} ms "
        f"(forward+backward {long['fwd_bwd_ms'][0]:.3f}; first step, CUDA "
        f"events), peak memory {long['peak_mem_bytes'] / 2**30:.2f} GiB")
    free_card()

    # -- restart: 12 steps with checkpoints, resumed to 18, against 18 --------
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    kw = dict(smoke=False, batch=RESTART_BATCH, seq=RESTART_SEQ,
              log_every=100, device="cuda", n_layers=2)
    try:
        t0 = time.perf_counter()
        train("qwen2-0.5b", steps=12, ckpt_dir=CKPT_DIR, resume=False,
              ckpt_every=6, **kw)
        resumed = train("qwen2-0.5b", steps=18, ckpt_dir=CKPT_DIR,
                        resume=True, ckpt_every=6, **kw)
        restart_s = time.perf_counter() - t0
        full = train("qwen2-0.5b", steps=18, ckpt_dir=None, resume=False,
                     **kw)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    gap = abs(resumed["last_loss"] - full["last_loss"])
    log(f"[train-restart] full width, 2 layers, batch {RESTART_BATCH} seq "
        f"{RESTART_SEQ}: 12 steps (checkpoints at 6 and 12) + resumed to 18 "
        f"in {restart_s:.1f} s; last loss resumed {resumed['last_loss']:.6f} "
        f"vs uninterrupted {full['last_loss']:.6f}: |diff| {gap:.3e} (<= "
        f"{RESTART_TOL})")
    if not gap <= RESTART_TOL:
        raise AssertionError("[train-restart] the resumed run departs from "
                             "the uninterrupted one")
    free_card()
    return {"step_ms": step_ms, "losses": losses}


# =============================================================================
# 16. the REPRO_* performance flags, and bounds from the cost model
# =============================================================================

FLAG_VARS = {"causal_skip": "REPRO_CAUSAL_SKIP",
             "chunked_ce": "REPRO_CHUNKED_CE",
             "window_slice": "REPRO_WINDOW_SLICE_DECODE",
             "kv_quant": "REPRO_KV_QUANT",
             "cache_update": "REPRO_CACHE_UPDATE"}
# Hymba-1.5B's sliced decode: window 1024 + 1 + 128 meta slots must be
# below the cache length for the slice to engage (phase 12's 1152-slot slab
# never does), so a 4096 + 128-slot cache after a 3000-token prompt
HYMBA_SLICE_CACHE, HYMBA_SLICE_PROMPT = 4096, 3000
# DeepSeek-V3's kv_quant decode: 8 rows after a 1024-position prefill, a
# 1152-slot slab (1024 + 128)
KVQ_PROMPT, KVQ_CACHE = 1024, 1152
# the reference's rule for the int8 latent (tests/test_flag_equivalence.py)
KVQ_REL = 0.05


@contextlib.contextmanager
def flag_set(name: str, value: str):
    """Set one REPRO_* variable around a measurement, then restore it."""
    var = FLAG_VARS[name]
    old = os.environ.get(var)
    os.environ[var] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = old


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _roofline(env: dict, what: str, cfg, cell, remat: bool,
              measured_ms: float, card: str) -> float:
    """``cell_cost`` with the H100's terms beside a measured time."""
    from repro_torch.launch.analytic_cost import cell_cost
    from repro_torch.launch.roofline import roofline_terms
    cost = cell_cost(cfg, cell, remat=remat)
    terms = roofline_terms(cost.flops, cost.bytes, 0.0, 1, hw=env["hw"])
    bound = terms["step_time_lower_bound_s"] * 1e3
    log(f"[roofline] {what}: cell_cost {cost.flops / 1e12:.4f} TFLOP, "
        f"{cost.bytes / 1e9:.4f} GB -> compute {terms['compute_s'] * 1e3:.4f}"
        f" ms, memory {terms['memory_s'] * 1e3:.4f} ms on {env['hw'].name} "
        f"({terms['dominant'].removesuffix('_s')} bound {bound:.4f} ms); "
        f"measured {measured_ms:.4f} ms, share of the bound "
        f"{bound / measured_ms:.4f} | {card}")
    return bound


def flags_chunked_attention(gen: torch.Generator, say) -> None:
    """``causal_skip`` on ``chunked_attention``'s forward at the heads the
    long prefills run (chunks of 2048, the last short): on vs off bit-equal
    in fp32 and bf16 (a skipped chunk adds exact zeros), the bf16 forward
    timed both ways."""
    from repro_torch.models.attention import chunked_attention
    for label, h, kvh, dk, dv, s in (
            ("qwen2 14/2x64", 14, 2, 64, 64, CHUNK_S),
            ("deepseek mla 128/1x576/512", 128, 1, 576, 512, CHUNK_S),
            ("llava 32/8x128", 32, 8, 128, 128, LLAVA_S)):
        skipped = (s - CHUNK) * CHUNK / (s * s)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype)
                       for shape in ((1, s, h, dk), (1, s, kvh, dk),
                                     (1, s, kvh, dv)))
            outs, ms = {}, {}
            for value in ("0", "1"):
                with flag_set("causal_skip", value):
                    outs[value] = chunked_attention(q, k, v, causal=True)
                    ms[value] = cuda_ms(lambda: chunked_attention(
                        q, k, v, causal=True), iters=5, warmup=1)
            diff = _max_diff(outs["1"], outs["0"])
            say(f"causal_skip chunked_attention {label} {_dt(dtype)} S=T={s}"
                f": on vs off max|diff| {diff:.3e} (fp32 <= 1e-5, bf16 "
                f"bit-equal expected: {torch.equal(outs['1'], outs['0'])}); "
                f"forward off {ms['0']:.3f} ms, on {ms['1']:.3f} ms "
                f"({1 - ms['1'] / ms['0']:+.4f} of it; the skipped pair is "
                f"{skipped:.4f} of the score rectangle)")
            bad = (diff > 1e-5 if dtype == torch.float32
                   else _agreement(outs["1"], outs["0"])[0] > LOGITS_REL_L2)
            if bad:
                raise AssertionError(f"[flags] causal_skip {label} "
                                     f"{_dt(dtype)}: on vs off {diff:.3e}")
            del q, k, v, outs
    free_card()


def flags_qwen2(env: dict, seed: int, train_step_ms: float, say) -> None:
    """Qwen2-0.5B at full width and depth: the cache-update modes on a
    decode tick at 8 x 1024 (bit-equal; the tick beside ``cell_cost``'s
    bound in scatter mode), ``causal_skip`` and ``chunked_ce`` on a
    training step at batch 1 x 2304, the 8 x 512 training step of phase 15
    beside its bound."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.capture import CudaGraphReplay
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import Model
    from repro_torch.utils.tree import tree_leaves, tree_map
    card = env["smi"].splitlines()[0]
    cfg = get_config("qwen2-0.5b")
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(seed),
                             "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 925)

    # -- the cache-update modes on a decode tick ------------------------------
    model = Model(cfg, use_kernels=True)
    tokens = torch.randint(1, cfg.vocab_size, (SLOTS, MAX_LEN - 1),
                           generator=g, device="cuda")
    reset_launches()
    logits, caches = model.prefill(params, {"tokens": tokens},
                                   cache_len=MAX_LEN)
    tok = logits.argmax(-1)
    pos = torch.full((SLOTS,), MAX_LEN - 1, dtype=torch.int32, device="cuda")
    ticks, ms = {}, {}
    for mode in ("where", "scatter"):
        with flag_set("cache_update", mode):
            # a recorded graph keeps the flags it saw: one a setting
            replay = CudaGraphReplay(
                lambda t, p: [model.decode(params, t, caches, p)[0]],
                [tok, pos])
            ticks[mode] = replay([tok, pos])[0].clone()
            ms[mode] = cuda_ms(lambda: replay([tok, pos]))
            del replay
    launches = read_launches("rmsnorm", "flash_attention", "decode_attention")
    if not torch.equal(ticks["where"], ticks["scatter"]):
        raise AssertionError("[flags] the scatter decode tick differs from "
                             "the where tick")
    if min(launches.values()) <= 0:
        raise AssertionError(f"[flags] qwen2 decode launched no kernel: "
                             f"{launches}")
    say(f"cache_update qwen2-0.5b decode tick at {SLOTS} x {MAX_LEN} "
        f"(kernel route, CUDA graph, median of {TIMING_ITERS}): where "
        f"{ms['where']:.4f} ms, scatter {ms['scatter']:.4f} ms, logits "
        f"bit-equal; launches over the prefill and both graphs {launches}")
    with flag_set("cache_update", "scatter"):
        _roofline(env, f"qwen2-0.5b decode tick {SLOTS} x {MAX_LEN} "
                  f"(REPRO_CACHE_UPDATE=scatter, the port's one-slot write)",
                  cfg, ShapeCell("tick", MAX_LEN, SLOTS, "decode"), False,
                  ms["scatter"], card)
    del caches, logits
    _roofline(env, f"qwen2-0.5b training step {TRAIN_BATCH} x {TRAIN_SEQ} "
              f"(phase 15's median, remat none)", cfg,
              ShapeCell("train", TRAIN_SEQ, TRAIN_BATCH, "train"), False,
              train_step_ms, card)
    say(f"chunked_ce at {TRAIN_BATCH} x {TRAIN_SEQ}: sequence chunks of 512 "
        f"make one chunk of {TRAIN_SEQ}, so the flag changes nothing there "
        f"(not measured)")
    free_card()

    # -- causal_skip and chunked_ce on a training step at 1 x 2304 -------------
    batch = {k: torch.randint(0, cfg.vocab_size, (1, CHUNK_S), generator=g,
                              device="cuda") for k in ("tokens", "labels")}
    sc = 512
    while CHUNK_S % sc:
        sc //= 2
    logits_gb = CHUNK_S * cfg.vocab_size * 4 / 1e9
    for dtype in (torch.bfloat16, torch.float32):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = params if dtype == torch.bfloat16 else tree_map(
            lambda t: t.float(), params)
        m = Model(c)
        runs = {}
        for name, value in (("off", None), ("causal_skip", "1"),
                            ("chunked_ce", "1")):
            ctx = (flag_set(name, value) if value
                   else contextlib.nullcontext())
            with ctx:
                free_card()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                loss, _, grads = loss_and_grads(m, p, batch)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                step_ms = cuda_ms(lambda: loss_and_grads(m, p, batch),
                                  iters=3, warmup=1)
            runs[name] = (loss, tree_leaves(grads), step_ms, peak)
            del grads
        loss0, grads0, ms0, peak0 = runs["off"]
        for name in ("causal_skip", "chunked_ce"):
            loss, grads, step_ms, peak = runs[name]
            loss_rel = abs(float(loss) - float(loss0)) / abs(float(loss0))
            grad_rel = max(_agreement(a, b)[0] for a, b in zip(grads, grads0))
            equal = torch.equal(loss, loss0) and all(
                torch.equal(a, b) for a, b in zip(grads, grads0))
            if dtype == torch.float32:
                gate = loss_rel <= 1e-5 and grad_rel <= 1e-4
                rule = "loss <= 1e-5, grads <= 1e-4"
            elif name == "causal_skip":
                gate = loss_rel <= LOGITS_REL_L2 and grad_rel <= LOGITS_REL_L2
                rule = f"<= {LOGITS_REL_L2}"
            else:
                # bf16 leaves take the chunks' grads summed in bf16 (the
                # tied head table once a chunk): reported, gated in fp32
                gate = True
                rule = "reported"
            extra = (f"; {CHUNK_S // sc} chunks of {sc}, full fp32 logits "
                     f"{logits_gb:.3f} GB a pass" if name == "chunked_ce"
                     else "")
            say(f"{name} qwen2-0.5b training step 1 x {CHUNK_S} "
                f"{_dt(dtype)}: loss rel {loss_rel:.3e}, worst grad leaf "
                f"rel_l2 {grad_rel:.3e} ({rule}; bit-equal {equal}); "
                f"loss+grads off {ms0:.3f} ms peak {peak0 / 2**30:.3f} GiB, "
                f"on {step_ms:.3f} ms peak {peak / 2**30:.3f} GiB{extra}")
            if not gate:
                raise AssertionError(f"[flags] {name} {_dt(dtype)} training "
                                     f"step departs from the flag off")
        del runs, p
        free_card()
    del params
    free_card()


def flags_hymba(env: dict, seed: int, say) -> None:
    """Hymba-1.5B at full width and depth, 8 rows of a 3000-token prompt in
    a 4096 + 128-slot cache (one bf16 kernel-route prefill; the fp32 ticks
    run on its caches and params cast up, so every tick starts from the
    same state): ``window_slice_decode`` on vs off on both routes.  fp32:
    within 1e-5 of max |logits| and top-1 equal.  bf16, where 32 layers
    carry any rounding difference to about 2e-2 of the logits (the plain
    route's on vs off, the same math summed in another order, read
    1.9e-2 and 2.3e-2 on the same inputs in two calls) and the flag swaps
    the kernel route's decode kernel for the plain attention (~4.7e-2,
    phase 12): each layer's attention on identical inputs on vs off
    within 2e-2, and each bf16 tick with the flag on no farther from the
    fp32 plain tick than max(2e-2, 1.25 x the bf16 plain route's distance
    without the flag).  Under the flag the
    kernel route launches no decode kernel; the graph tick recorded under
    the flag is bit-equal to the eager tick; ticks timed both ways."""
    from repro_torch.configs import get_config
    from repro_torch.core.capture import CudaGraphReplay
    from repro_torch.models import Model
    from repro_torch.models.transformer import stack_meta
    from repro_torch.serving.engine import _leaves
    from repro_torch.utils.tree import tree_map
    cfg = get_config("hymba-1.5b")
    t = HYMBA_SLICE_CACHE + cfg.meta_tokens
    if not cfg.window + 1 + cfg.meta_tokens < t:
        raise AssertionError("the slice does not engage at this cache")
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(seed),
                             "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 930)
    tokens = torch.randint(1, cfg.vocab_size, (SLOTS, HYMBA_SLICE_PROMPT),
                           generator=g, device="cuda")
    pos = torch.full((SLOTS,), HYMBA_SLICE_PROMPT, dtype=torch.int32,
                     device="cuda")
    n_win = sum(w > 0 for _, _, ws in stack_meta(cfg) for w in ws)
    kernel = Model(cfg, use_kernels=True)
    reset_launches()
    t0 = time.perf_counter()
    logits, caches = kernel.prefill(params, {"tokens": tokens}, cache_len=t)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    flash = read_launches("flash_attention")["flash_attention"]
    tok = logits.argmax(-1)
    del logits
    truth = None
    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, dtype=dtype)
        if dtype == torch.float32:
            p = tree_map(lambda x: x.float(), params)
            state = tree_map(lambda x: x.float(), caches)
        else:
            p, state = params, caches
        kept = [x.clone() for x in _leaves(state)]

        def restore():
            for leaf, k in zip(_leaves(state), kept):
                leaf.copy_(k)
        out, dec = {}, {}
        for route in (True, False):
            m = Model(c, use_kernels=route)
            for value in ("0", "1"):
                with flag_set("window_slice", value):
                    restore()
                    reset_launches()
                    out[route, value] = m.decode(p, tok, state, pos)[0]
                    dec[route, value] = read_launches(
                        "rmsnorm", "decode_attention")
        if dtype == torch.float32:
            truth = out[False, "0"]
        else:
            plain_off = _agreement(out[False, "0"], truth)[0]
            limit = max(LOGITS_REL_L2, 1.25 * plain_off)
            restore()
            blocks = _sliced_attention_blocks(c, p, state, pos, g)
            say(f"window_slice hymba-1.5b bf16 attention of each of the "
                f"{cfg.n_layers} layers on identical inputs (plain, the "
                f"prefill's K/V): on vs off worst rel_l2 {blocks:.3e} (<= "
                f"{LOGITS_REL_L2})")
            if not blocks <= LOGITS_REL_L2:
                raise AssertionError("[flags] window_slice bf16 attention "
                                     "departs from the flag off")
        for route in (True, False):
            off, on = out[route, "0"], out[route, "1"]
            name = "kernel" if route else "plain"
            if dtype == torch.float32:
                diff = _max_diff(on, off)
                scale = float(off.abs().max())
                top1 = bool(torch.equal(on.argmax(-1), off.argmax(-1)))
                ok = diff <= FP32_TOL * scale and top1
                got = (f"max|diff| {diff:.3e} (<= {FP32_TOL} x max|off| "
                       f"{scale:.3f}), top-1 equal {top1}")
            else:
                rel = _agreement(on, off)[0]
                d_on, d_off = (_agreement(x, truth)[0] for x in (on, off))
                ok = d_on <= limit
                rule = ("the flag swaps the decode kernel for the plain "
                        "attention" if route else "a reduction-order "
                        "change carried through the bf16 layers")
                got = (f"rel_l2 {rel:.3e} (reported: {rule}); from the "
                       f"fp32 plain tick: on {d_on:.3e} (<= {limit:.3e}), "
                       f"off {d_off:.3e}")
            say(f"window_slice hymba-1.5b {_dt(dtype)} {name} route, {SLOTS}"
                f" rows at position {HYMBA_SLICE_PROMPT} + {cfg.meta_tokens}"
                f" meta of {t} slots: on vs off {got}; launches off "
                f"{dec[route, '0']}, on {dec[route, '1']}")
            if not ok:
                raise AssertionError(f"[flags] window_slice {_dt(dtype)} "
                                     f"{name} route departs from the flag "
                                     f"off")
        if dec[True, "1"]["decode_attention"] != 0 or \
                dec[True, "0"]["decode_attention"] <= 0 or \
                dec[True, "1"]["rmsnorm"] <= 0 or flash <= 0:
            raise AssertionError(f"[flags] hymba launches: prefill flash "
                                 f"{flash}, decode {dec}")
        if dtype == torch.float32:
            del p, state, kept, out
            free_card()
            continue
        ms = {}
        for value in ("0", "1"):
            with flag_set("window_slice", value):
                restore()
                replay = CudaGraphReplay(
                    lambda a, b: [kernel.decode(p, a, state, b)[0]],
                    [tok, pos])
                restore()
                graph = replay([tok, pos])[0].clone()
                restore()
                eager = kernel.decode(p, tok, state, pos)[0]
                if not torch.equal(graph, eager):
                    raise AssertionError(
                        f"[flags] hymba graph tick differs from the eager "
                        f"tick (window_slice {value})")
                ms[value] = cuda_ms(lambda: replay([tok, pos]))
                del replay
        say(f"window_slice hymba-1.5b bf16 kernel-route tick at {SLOTS} "
            f"rows, CUDA graph (median of {TIMING_ITERS}; graph == eager "
            f"both ways): off {ms['0']:.4f} ms, on {ms['1']:.4f} ms; the "
            f"{n_win} windowed layers read {cfg.window + 1} of {t} slots, "
            f"the {cfg.n_layers - n_win} global ones all; prefill {SLOTS} x "
            f"{HYMBA_SLICE_PROMPT} {prefill_s:.2f} s")
    del caches, params, kept, out
    free_card()


def _sliced_attention_blocks(cfg, params, caches, pos, g) -> float:
    """Each layer's decode attention (plain) on one random input and the
    prefill's K/V, ``window_slice_decode`` on vs off: the worst relative
    L2."""
    from repro_torch.models.attention import gqa_decode
    from repro_torch.models.transformer import (_window, layer_params,
                                                stack_meta)
    x = torch.randn((SLOTS, 1, cfg.d_model), generator=g,
                    device="cuda").to(cfg.dtype)
    k, v = caches[0]["kv"]
    worst = 0.0
    for li, w in enumerate(stack_meta(cfg)[0][2]):
        attn = layer_params(params["stacks"][0], li)["attn"]
        outs = []
        for value in ("0", "1"):
            with flag_set("window_slice", value):
                outs.append(gqa_decode(
                    attn, x, (k[li].clone(), v[li].clone()),
                    pos + cfg.meta_tokens, cfg, _window(w))[0])
        worst = max(worst, _agreement(outs[1], outs[0])[0])
    return worst


def _quantise_latent(c: torch.Tensor) -> tuple:
    """The reference test's recipe: per-token absmax scale / 127 (fp16),
    the latent rounded to int8."""
    scale = c.float().abs().amax(-1).clamp_min(1e-6) / 127.0
    q = torch.clamp(torch.round(c.float() / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def flags_deepseek(env: dict, seed: int, say) -> None:
    """DeepSeek-V3 at full width, 4 of 61 layers: ``causal_skip`` on the
    2304-token plain prefill (bit-equal, timed both ways); ``kv_quant`` on
    the dense decode at 8 rows after a 1024-position prefill (logits within
    5% of the bf16-cache tick, int8 / fp16 leaves, the cache bytes from
    ``decode_state_specs``, ticks timed and beside ``cell_cost``'s bounds),
    and the engine: paged degrades to the dense slab, whose first admission
    raises (ROADMAP C19) with no leaf written."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.capture import CudaGraphReplay
    from repro_torch.models import Model
    from repro_torch.runtime.guard import DegradationWarning
    from repro_torch.serving import InferenceEngine, Request
    from repro_torch.serving.engine import _leaves
    card = env["smi"].splitlines()[0]
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"),
                              n_layers=DS_LAYERS)
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(seed),
                             "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 940)

    # -- causal_skip on the 2304-token plain prefill ----------------------------
    tokens = torch.randint(1, cfg.vocab_size, (1, DS_LONG), generator=g,
                           device="cuda")
    plain = Model(cfg, use_kernels=False)
    out, ms = {}, {}
    for value in ("0", "1"):
        with flag_set("causal_skip", value):
            out[value] = plain.prefill(params, {"tokens": tokens})[0]
            ms[value] = cuda_ms(lambda: plain.prefill(params,
                                                      {"tokens": tokens}),
                                iters=3, warmup=1)
    rel = _agreement(out["1"], out["0"])[0]
    say(f"causal_skip deepseek-v3 {DS_LAYERS} layers bf16 {DS_LONG}-token "
        f"plain prefill (MLA chunked): on vs off max|diff| "
        f"{_max_diff(out['1'], out['0']):.3e}, rel_l2 {rel:.3e} (<= "
        f"{LOGITS_REL_L2}; bit-equal {torch.equal(out['1'], out['0'])}); "
        f"prefill off {ms['0']:.3f} ms, on {ms['1']:.3f} ms (median of 3)")
    if not rel <= LOGITS_REL_L2:
        raise AssertionError("[flags] causal_skip deepseek prefill departs")
    del out
    free_card()

    # -- kv_quant: dense decode at 8 rows after 1024 positions -----------------
    model = Model(cfg, use_kernels=True)
    reset_launches()
    rows, toks = [], []
    for _ in range(SLOTS):
        prompt = torch.randint(1, cfg.vocab_size, (1, KVQ_PROMPT),
                               generator=g, device="cuda")
        logits, cache = model.prefill(params, {"tokens": prompt},
                                      cache_len=KVQ_CACHE)
        rows.append(cache)
        toks.append(logits.argmax(-1))
    caches = [tuple(torch.cat([r[s][i] for r in rows], 1)
                    for i in range(2)) for s in range(len(rows[0]))]
    del rows
    tok = torch.cat(toks)
    pos = torch.full((SLOTS,), KVQ_PROMPT, dtype=torch.int32, device="cuda")
    quant = [(*_quantise_latent(ck), rk.clone()) for ck, rk in caches]
    ticks, tick_ms = {}, {}
    for value, cache in (("0", caches), ("1", quant)):
        with flag_set("kv_quant", value), flag_set("cache_update", "scatter"):
            replay = CudaGraphReplay(
                lambda a, b: [model.decode(params, a, cache, b)[0]],
                [tok, pos])
            ticks[value] = replay([tok, pos])[0].clone()
            tick_ms[value] = cuda_ms(lambda: replay([tok, pos]))
            del replay
    launches = read_launches("rmsnorm", "moe_gemm")
    if min(launches.values()) <= 0:
        raise AssertionError(f"[flags] deepseek decode launches {launches}")
    rel = _max_diff(ticks["1"], ticks["0"]) / float(ticks["0"].float().abs()
                                                   .max())
    dtypes = [str(leaf.dtype) for leaf in quant[0]]
    cell = ShapeCell("tick", KVQ_CACHE, SLOTS, "decode")
    nbytes = {}
    for value in ("0", "1"):
        with flag_set("kv_quant", value):
            specs = Model(cfg).decode_state_specs(cell)
            nbytes[value] = sum(x.numel() * x.element_size()
                                for x in _leaves(specs))
    m = cfg.mla
    want_ratio = (m.kv_lora_rank + 2 + 2 * m.qk_rope_head_dim) / (
        2 * (m.kv_lora_rank + m.qk_rope_head_dim))
    ratio = nbytes["1"] / nbytes["0"]
    say(f"kv_quant deepseek-v3 {DS_LAYERS} layers bf16 dense decode tick at "
        f"{SLOTS} rows after {KVQ_PROMPT} positions ({KVQ_CACHE}-slot slab, "
        f"kernel route, CUDA graph, median of {TIMING_ITERS}): bf16 cache "
        f"{tick_ms['0']:.4f} ms, int8 cache {tick_ms['1']:.4f} ms; logits "
        f"max|diff| / max|bf16| {rel:.4f} (< {KVQ_REL}); leaves {dtypes}; "
        f"cache bytes from decode_state_specs {nbytes['1']} / {nbytes['0']} "
        f"= {ratio:.4f} (want {want_ratio:.4f}); launches {launches}")
    if not (rel < KVQ_REL and dtypes[:2] == ["torch.int8", "torch.float16"]
            and abs(ratio - want_ratio) < 1e-12):
        raise AssertionError("[flags] kv_quant decode fails its gates")
    for value in ("0", "1"):
        with flag_set("kv_quant", value), flag_set("cache_update", "scatter"):
            _roofline(env, f"deepseek-v3 {DS_LAYERS} layers decode tick "
                      f"{SLOTS} x {KVQ_CACHE} ({'int8' if value == '1' else 'bf16'}"
                      f" latent cache, REPRO_CACHE_UPDATE=scatter)", cfg, cell,
                      False, tick_ms[value], card)
    del caches, quant, ticks
    free_card()

    # -- the engine under kv_quant ----------------------------------------------
    with flag_set("kv_quant", "1"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = InferenceEngine(Model(cfg, use_kernels=True), params,
                                  max_slots=SLOTS, max_len=MAX_LEN,
                                  seed=seed, paged_kv=True, page_size=PAGE)
        degraded = [str(w.message) for w in caught
                    if issubclass(w.category, DegradationWarning)]
        if eng.paged or not degraded:
            raise AssertionError("[flags] kv_quant paged MLA did not degrade")
        before = [x.clone() for x in _leaves(eng.caches)]
        eng.submit(Request(rid=0, prompt=list(range(1, 17)), max_tokens=4))
        try:
            eng.step()
        except ValueError as exc:
            raised = str(exc)
        else:
            raise AssertionError("[flags] the kv_quant dense admission did "
                                 "not raise (ROADMAP C19)")
        unchanged = all(torch.equal(a, b)
                        for a, b in zip(before, _leaves(eng.caches)))
        if "arity mismatch" not in raised or not unchanged:
            raise AssertionError(f"[flags] C19: {raised!r}, caches "
                                 f"unchanged {unchanged}")
    say(f"kv_quant engine: paged_kv=True degraded to the dense slab "
        f"({degraded[0][:90]}...); the first dense admission raised "
        f"ValueError({raised!r}) with every cache leaf unchanged (ROADMAP "
        f"C19, as the reference's engine raises)")
    del eng, before, params
    free_card()


def phase_flags(env: dict, gen: torch.Generator, seed: int,
                train_step_ms: float) -> None:
    card = env["smi"].splitlines()[0]

    def say(msg: str) -> None:
        log(f"[flags] {msg} | {card}")
    for var in FLAG_VARS.values():
        if var in os.environ:
            raise AssertionError(f"{var} is set: the earlier phases ran "
                                 "with a flag on")
    t0 = time.perf_counter()
    flags_chunked_attention(gen, say)
    flags_qwen2(env, seed, train_step_ms, say)
    flags_hymba(env, seed, say)
    flags_deepseek(env, seed, say)
    log(f"[flags] phase took {time.perf_counter() - t0:.1f} s")


# =============================================================================
# 17. the distribution layer on a 1-rank NCCL mesh
# =============================================================================

MESH_ITERS, MESH_WARMUP = 10, 3
MESH_CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "mesh_ckpt")


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_batch(mesh, cfg, batch: dict) -> tuple:
    """(the batch as ``DTensor``s laid out by ``batch_specs``, the context
    a sharded step runs in: the activation rules of the batch's cell, and
    plain tensors made inside the model read as replicated)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import ShapeCell
    from repro_torch.parallel.sharding import (activation_rules, batch_specs,
                                               place)
    from repro_torch.utils import logical_axis_rules
    b, s = batch["tokens"].shape
    cell = ShapeCell("mesh", s, b, "train")
    sp = batch_specs(mesh, cfg, batch, cell)

    @contextlib.contextmanager
    def ctx():
        with logical_axis_rules(activation_rules(mesh, cell), mesh), \
                implicit_replication():
            yield
    return {k: place(v, mesh, sp[k]) for k, v in batch.items()}, ctx


def mesh_params(mesh, params):
    """``params`` as ``DTensor``s laid out by ``param_shardings``."""
    from repro_torch.parallel.sharding import param_shardings, place_tree
    return place_tree(params, param_shardings(mesh, params), mesh)


def mesh_fp32_gate(mesh, seed: int, device: str = "cuda",
                   n_layers: int = 2, batch: int = TRAIN_BATCH,
                   seq: int = TRAIN_SEQ) -> None:
    """One fp32 loss+grads of full-width Qwen2-0.5B cut to ``n_layers``,
    sharded on ``mesh`` against plain, same params and batch."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_dataset
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import Model
    from repro_torch.utils.tree import tree_leaves
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=n_layers,
                              dtype=torch.float32)
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device)
    data = {k: torch.from_numpy(v).to(device, torch.long) for k, v in
            make_dataset(cfg.vocab_size, seq, batch).batch_at(0).items()}
    loss, _, grads = loss_and_grads(model, params, data, seed)
    params_s = mesh_params(mesh, params)
    batch_s, ctx = mesh_batch(mesh, cfg, data)
    with ctx():
        loss_s, _, grads_s = loss_and_grads(model, params_s, batch_s, seed)
    loss_s = loss_s.full_tensor()
    grads_s = [g.full_tensor() for g in tree_leaves(grads_s)]
    grads = tree_leaves(grads)
    loss_rel = float((loss_s - loss).abs() / loss.abs())
    grad_rel = max(_agreement(a, b)[0] for a, b in zip(grads_s, grads))
    bit_equal = bool(torch.equal(loss_s, loss) and all(
        torch.equal(a, b) for a, b in zip(grads_s, grads)))
    log(f"[mesh] fp32 {cfg.name} d={cfg.d_model} {n_layers} layers batch "
        f"{batch} seq {seq}, sharded on {tuple(mesh.shape)} vs plain: loss "
        f"{float(loss):.6f} rel {loss_rel:.3e} (<= 1e-5), worst grad leaf "
        f"rel_l2 {grad_rel:.3e} (<= 1e-4), bit-equal: {bit_equal}")
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4):
        raise AssertionError("[mesh] the sharded step disagrees with plain")


def mesh_bf16_timing(mesh, seed: int, device: str = "cuda",
                     n_layers: int | None = None, batch: int = TRAIN_BATCH,
                     seq: int = TRAIN_SEQ, iters: int = MESH_ITERS,
                     warmup: int = MESH_WARMUP) -> dict:
    """The full-depth bf16 train step plain and sharded on ``mesh``: the
    median of ``iters`` steps after ``warmup`` (CUDA events on the card),
    and the idle share of one more step each from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data import make_dataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    cfg = get_config("qwen2-0.5b")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = Model(cfg)
    step = make_train_step(model, ParallelConfig(remat="none"),
                           base_lr=1e-3, warmup=10, total_steps=1000)
    data = make_dataset(cfg.vocab_size, seq, batch)
    out = {}
    for how in ("plain", "sharded"):
        params = model.init(torch.Generator(device=device).manual_seed(seed),
                            device)
        if how == "sharded":
            params = mesh_params(mesh, params)
        opt = adamw_init(params)
        times, losses = [], []
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for i in range(warmup + iters + 1):
            b = {k: torch.from_numpy(v).to(device, torch.long)
                 for k, v in data.batch_at(i).items()}
            ctx = contextlib.nullcontext
            if how == "sharded":
                b, ctx = mesh_batch(mesh, cfg, b)
            timed = warmup <= i < warmup + iters
            profiled = i == warmup + iters and device == "cuda"
            ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  if device == "cuda" else None)
            prof = (profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
                    if profiled else contextlib.nullcontext())
            with prof, ctx():
                t0 = time.perf_counter()
                if ev:
                    ev[0].record()
                params, opt, metrics = step(params, opt, b, i)
                if ev:
                    ev[1].record()
                    ev[1].synchronize()
                loss = metrics["loss"]
                loss = float(loss.full_tensor() if how == "sharded"
                             else loss)
                wall_ms = (time.perf_counter() - t0) * 1e3
            losses.append(loss)
            if timed:
                times.append(ev[0].elapsed_time(ev[1]) if ev else wall_ms)
            if profiled:
                kernels = [e for e in prof.events()
                           if e.device_type == DeviceType.CUDA]
                busy = busy_and_overlap([(e.time_range.start,
                                          e.time_range.end)
                                         for e in kernels])[0] / 1e3
                out[how + "_idle"] = max(0.0, 1 - busy / wall_ms) \
                    if kernels else float("nan")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[mesh] {how} bf16 loss not finite")
        out[how] = statistics.median(times)
        if device == "cuda":
            out[how + "_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out[how + "_losses"] = losses
        del params, opt
        free_card()
    log(f"[mesh] bf16 {cfg.name} full depth ({cfg.n_layers} layers) batch "
        f"{batch} seq {seq}, step ms (median of {iters} after {warmup}, "
        f"CUDA events): plain {out['plain']:.3f}, sharded on "
        f"{tuple(mesh.shape)} {out['sharded']:.3f} (x"
        f"{out['sharded'] / out['plain']:.2f}); idle share of one step "
        f"(torch.profiler): plain {out.get('plain_idle', float('nan')):.3f}"
        f", sharded {out.get('sharded_idle', float('nan')):.3f}; peak "
        f"memory (torch.cuda.max_memory_allocated): plain "
        f"{out.get('plain_peak_gib', float('nan')):.2f} GiB, sharded "
        f"{out.get('sharded_peak_gib', float('nan')):.2f} GiB; first "
        f"losses {out['plain_losses'][0]:.4f} / "
        f"{out['sharded_losses'][0]:.4f}")
    return out


def mesh_gloo_every_arch() -> None:
    """``tests/test_torch_distributed.py``'s every-arch check (fp32 loss and
    grads, the bf16 gate, plain tensors in every product, combine and
    scan) on this machine's CPU and torch: two groups of 4 gloo ranks at
    once, half the decoder archs each; rank 0 of each prints a line an
    arch, and a failing arch fails the group."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from test_torch_distributed import EVERY_ARCH, _every_arch_worker
    # about equal halves of the work (DeepSeek-V3 takes the most)
    first = ("deepseek-v3-671b", "glm4-9b", "hymba-1.5b",
             "llava-next-mistral-7b")
    halves = (first, tuple(a for a in EVERY_ARCH if a not in first))
    groups = [mp.start_processes(_every_arch_worker,
                                 args=(_free_port(), archs), nprocs=4,
                                 join=False, start_method="spawn")
              for archs in halves]
    try:
        for group in groups:
            while not group.join():
                pass
    finally:
        for group in groups:
            for proc in group.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join()
    log(f"[mesh-gloo] torch {torch.__version__}, 2 x 4 gloo ranks on the "
        f"CPU, {len(EVERY_ARCH)} decoder archs on a 2x2 mesh: every arch ok "
        f"in {time.perf_counter() - t0:.1f} s")


def mesh_collectives_and_restore(mesh, seed: int,
                                 device: str = "cuda") -> None:
    """``collective_matmul`` and ``quantized_psum`` on the mesh against
    their single-device meaning, and a checkpoint restored onto it."""
    from repro_torch.checkpoint.checkpointer import (CheckpointSpec,
                                                     Checkpointer)
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.parallel.collectives import (collective_matmul,
                                                  quantized_psum)
    from repro_torch.parallel.sharding import param_shardings
    from repro_torch.utils.tree import tree_leaves
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(TRAIN_BATCH * TRAIN_SEQ, 896, generator=g,
                    device=device).to(torch.bfloat16)
    w = (torch.randn(896, 4864, generator=g, device=device) * 0.03).to(
        torch.bfloat16)
    cm = collective_matmul(x, w, mesh, "model")
    want = torch.matmul(x.float(), w.float()).to(torch.bfloat16)
    cm_err = float((cm.float() - want.float()).abs().max())
    grad = torch.randn(4864, 896, generator=g, device=device)
    qp = quantized_psum(grad, mesh, "data")
    scale = grad.abs().max().clamp_min(1e-8) / 127.0
    qd = torch.clamp(torch.round(grad / scale), -127, 127) * scale
    qp_err = float((qp - qd).abs().max())
    log(f"[mesh] collective_matmul [{x.shape[0]}, 896] @ [896, 4864] bf16 "
        f"on the model dim vs x @ w: max |diff| {cm_err:.3e} (<= "
        f"{BF16_TOL} x max|x @ w|); quantized_psum of [4864, 896] fp32 vs "
        f"its quantise-dequantise: max |diff| {qp_err:.3e} (<= 1e-6)")
    if not (cm_err <= BF16_TOL * float(want.float().abs().max())
            and qp_err <= 1e-6):
        raise AssertionError("[mesh] a collective disagrees")
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2)
    params = Model(cfg).init(torch.Generator(device=device).manual_seed(
        seed), device)
    shutil.rmtree(MESH_CKPT_DIR, ignore_errors=True)
    try:
        ck = Checkpointer(CheckpointSpec(MESH_CKPT_DIR))
        ck.save(1, params, blocking=True)
        specs = param_shardings(mesh, params)
        got = ck.restore(1, like=params, shardings=(specs, mesh))
    finally:
        shutil.rmtree(MESH_CKPT_DIR, ignore_errors=True)
    equal = all(torch.equal(a.to_local(), b) and a.device_mesh is mesh
                for a, b in zip(tree_leaves(got), tree_leaves(params)))
    log(f"[mesh] sharded restore of {len(tree_leaves(params))} leaves onto "
        f"{tuple(mesh.shape)}: every local shard bit-equal: {equal}")
    if not equal:
        raise AssertionError("[mesh] the sharded restore is not bit-equal")


def phase_mesh(seed: int) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_debug_mesh(1, 1)
        log(f"[mesh] NCCL process group of 1 rank, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on cuda")
        mesh_fp32_gate(mesh, seed)
        free_card()
        mesh_bf16_timing(mesh, seed)
        mesh_collectives_and_restore(mesh, seed)
    finally:
        dist.destroy_process_group()
    free_card()
    mesh_gloo_every_arch()
    log("[mesh] more than one card: not measured (one H100 forms only a "
        "1-rank mesh); the collective bytes of the 16x16 and 2x16x16 "
        "meshes are the dry-run's reckoning (python -m "
        "repro_torch.launch.dryrun), not measurements")
    log(f"[mesh] phase took {time.perf_counter() - t0:.1f} s")


# =============================================================================
# 18. chaos: every fault site at full width
# =============================================================================

CHAOS_CALIB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "chaos_calib")
# the kernels the chaos scenarios launch (the graph sites' GEMMs, the
# engine's norm, prefill, dense and paged decode)
CHAOS_KERNELS = ("branch_gemm", "grouped_gemm", "rmsnorm", "flash_attention",
                 "decode_attention", "paged_decode")


def phase_chaos(seed: int) -> dict:
    chaos = chaos_script
    t0 = time.perf_counter()
    shutil.rmtree(CHAOS_CALIB_DIR, ignore_errors=True)
    setup = chaos.Setup("cuda", "full", seed, calib_dir=CHAOS_CALIB_DIR)
    try:
        # -- the chaos path's run: launch counts from 0 ---------------------
        reset_launches()
        failures = chaos.run_all(setup, say=log)
        torch.cuda.synchronize()
        launches = read_launches(*CHAOS_KERNELS)
        routes = chaos.launch_counts()
        # -- end of the chaos path's run -------------------------------------
    finally:
        setup.close()
        shutil.rmtree(CHAOS_CALIB_DIR, ignore_errors=True)
    log(f"[chaos] wrapper launches over the phase {launches}, by route "
        f"{ {k: {r: n for r, n in v.items() if n} for k, v in routes.items()} }")
    if failures:
        raise AssertionError(f"[chaos] {failures} fault sites broke the "
                             "contract")
    log(f"[chaos] phase took {time.perf_counter() - t0:.1f} s")
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
    free_card()
    dense = phase_dense_archs(args.seed)
    free_card()
    hymba = phase_hymba(args.seed)
    free_card()
    whisper = phase_whisper(args.seed)
    free_card()
    llava = phase_llava(args.seed)
    free_card()
    training = phase_training(env, gen, args.seed)
    free_card()
    phase_flags(env, gen, args.seed, training["step_ms"])
    free_card()
    phase_mesh(args.seed)
    free_card()
    chaos = phase_chaos(args.seed)
    free_card()

    for path, launches in (("main", main_path["launches"]["branch_gemm"]),
                           ("ragged", ragged["launches"]["grouped_gemm"]),
                           ("kimi graph",
                            kimi["graph"]["launches"]["grouped_gemm"]),
                           ("deepseek graph (branch_gemm)",
                            deepseek["graph"]["launches"]["branch_gemm"]),
                           ("deepseek graph (grouped_gemm)",
                            deepseek["graph"]["launches"]["grouped_gemm"]),
                           ("rwkv graph", rwkv["graph"]["launches"]["rwkv6"]),
                           *((f"{name} graph", d["graph"]["branch_gemm"])
                             for name, d in dense.items()),
                           ("hymba graph", hymba["graph"]["branch_gemm"]),
                           ("whisper graph", whisper["graph"]["branch_gemm"]),
                           ("whisper facade (flash_attention)",
                            whisper["facade"]["flash_attention"]),
                           ("whisper facade (decode_attention)",
                            whisper["facade"]["decode_attention"]),
                           ("llava graph", llava["graph"]["branch_gemm"]),
                           *((f"llava {path} ({name})", llava[path][name])
                             for path, names in (
                                 ("facade", ("rmsnorm", "flash_attention",
                                             "decode_attention")),
                                 ("serve", ("flash_attention",
                                            "decode_attention",
                                            "paged_decode")))
                             for name in names),
                           *((f"chaos ({name})", n)
                             for name, n in chaos["launches"].items())):
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
