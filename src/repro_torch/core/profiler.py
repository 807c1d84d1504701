"""Model Profiler (paper §3.2).

A copy of the JAX package's ``core/profiler.py``: the analytic cost helpers
are bit-identical, :data:`V5E` stays for parity with the reference, and
:func:`detect_hardware` adds the data-sheet spec of the H100 part that
``torch.cuda.get_device_name()`` names.  :meth:`ModelProfiler.measure`
times with ``torch.cuda.Event`` on a CUDA graph and ``perf_counter`` on a
CPU one.

GPU Opara profiles per-block (threads, registers, shared memory) with
``torch.profiler``.  On TPU the analogous per-operator resource demands are
(FLOPs, HBM bytes moved, VMEM working set) — see DESIGN.md §2.  Two modes:

* **analytic** — models fill :class:`OpCost` at graph-build time from shapes
  (always available; used for dry-runs at production scale);
* **measured** — one profiling inference per model (the paper's "profile each
  DNN inference only once"): every op payload is timed on the device its
  tensors live on and ``measured_us`` recorded.

Measurement / mutation split (the calibration lifecycle)
--------------------------------------------------------
Timing and graph mutation are separate steps so measured profiles can be
cached and re-used ("profile once", then amortize):

* :meth:`ModelProfiler.measure` runs the single profiling inference and
  returns a detachable :class:`ProfileTable` — it never touches the graph;
* :func:`apply_profile` hydrates ``node.cost.measured_us`` from a table and
  stamps the table's fingerprint on the graph (``graph.calibration_fp``), so
  cache keys can distinguish calibrated from uncalibrated graphs without the
  raw timings leaking into the *structural* signature;
* :func:`detach_profile` reverses it, returning the graph to the analytic
  state (and handing back the table).

The calibration cache on :class:`repro_torch.core.Session` keys tables by
``(graph.node_signature(), graph.input_signature(inputs), hw.name)``: the
structural graph shape, the input shapes/dtypes the profiling run saw, and
the hardware the timings are valid for.  A structurally identical graph
(e.g. a reloaded checkpoint) hydrates from the cache instead of re-timing.
``profile_measured`` remains as the one-call convenience (measure + apply).

The intensity classification (compute- vs memory-intensive, paper §3.3 /
Fig. 3) is kind-aware: the paper classifies operators *offline by profiled
metrics*, which at framework granularity separates MXU-engaging kinds
(GEMM / conv / attention / scan) from HBM-streaming ones (element-wise,
norm, gather).  A pure arithmetic-intensity-vs-ridge-point test misfires at
inference scale — the v5e ridge is ~240 FLOP/byte, which no batch-1
operator reaches, so every op would land in one class and Algorithm 2's
alternation (and the wave repacker's complementary fill) would have nothing
to mix.  MXU kinds therefore classify COMPUTE once their analytic intensity
clears :data:`COMPUTE_AI_FLOOR` (degenerate skinny GEMMs stay memory-bound);
everything else falls back to the roofline test.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Mapping

import torch

from .graph import IntensityClass, OpCost, OpGraph, OpKind, OpNode


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants.  Defaults = TPU v5e (the reference's spec, kept so
    plans can be compared with the JAX package's bit for bit)."""

    name: str = "tpu-v5e"
    peak_flops: float = 197e12        # bf16 FLOP/s per chip
    hbm_bw: float = 819e9             # bytes/s
    ici_bw: float = 50e9              # bytes/s per link
    vmem_bytes: float = 128 * 2**20   # ~128 MiB VMEM per core (v5e ~128MB)
    hbm_bytes: float = 16 * 2**30     # 16 GiB HBM
    # execution-time floor for one kernel (setup/drain of the systolic array,
    # DMA latency): small ops never hit the roofline — this is exactly the
    # under-utilization the paper's Fig. 1 measures on GPUs.  0 in unit
    # tests; benchmarks use ~2 µs.
    min_kernel_us: float = 0.0

    @property
    def machine_balance(self) -> float:
        """FLOP/byte at the roofline ridge point (~240 for v5e)."""
        return self.peak_flops / self.hbm_bw


V5E = HardwareSpec()

# NVIDIA H100 data sheet, dense bf16 tensor-core rate (the sheet quotes the
# rate with sparsity, twice these), HBM bandwidth and size, NVLink per
# direction (half the sheet's bidirectional figure).  ``vmem_bytes`` is the
# shared memory of all SMs (132 or 114 SMs × 228 KB), the on-chip pool the
# scheduler's resource demand fragments.
H100_SXM = HardwareSpec(
    name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
    vmem_bytes=132 * 228 * 2**10, hbm_bytes=80e9)
H100_PCIE = HardwareSpec(
    name="h100-pcie", peak_flops=756e12, hbm_bw=2.0e12, ici_bw=300e9,
    vmem_bytes=114 * 228 * 2**10, hbm_bytes=80e9)
H100_NVL = HardwareSpec(
    name="h100-nvl", peak_flops=835e12, hbm_bw=3.9e12, ici_bw=300e9,
    vmem_bytes=132 * 228 * 2**10, hbm_bytes=94e9)


def hardware_for_name(device_name: str) -> HardwareSpec:
    """The data-sheet spec of the H100 part a CUDA device name names
    (``"NVIDIA H100 80GB HBM3"`` is the SXM part).  Raises for any other
    card rather than guessing its numbers."""
    if "H100" in device_name:
        if "PCIe" in device_name:
            return H100_PCIE
        if "NVL" in device_name:
            return H100_NVL
        if "HBM3" in device_name or "SXM" in device_name:
            return H100_SXM
    raise ValueError(f"no hardware spec for CUDA device {device_name!r}; "
                     "pass SessionConfig(hw=...) explicitly")


def detect_hardware() -> HardwareSpec:
    """Spec of CUDA device 0.  Raises when there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass a HardwareSpec explicitly "
                           "to schedule for the CPU")
    return hardware_for_name(torch.cuda.get_device_name(0))


@dataclasses.dataclass
class OpProfile:
    """Profiler output for one op."""

    cost: OpCost
    intensity: IntensityClass
    est_us: float  # roofline-model execution time estimate


@dataclasses.dataclass(frozen=True)
class ProfileTable:
    """Detachable measured-timing table — the calibration artifact.

    One profiling inference produces one table; :func:`apply_profile` hydrates
    a (structurally identical) graph from it, :func:`detach_profile` strips it
    back off.  Hashable, so the table doubles as its own cache value and its
    ``fingerprint`` as a plan-cache key component.
    """

    hw_name: str
    measured_us: tuple[tuple[int, float], ...]  # (op_id, wall µs), sorted

    @functools.cached_property
    def fingerprint(self) -> tuple:
        """Compact identity: (hw_name, sha1-of-timings, n).  Plan/executable
        cache keys embed this for every calibrated graph, so it must stay
        O(1) to hash — a raw per-op timing tuple would put O(n) floats back
        into every warm-path cache probe."""
        import hashlib

        digest = hashlib.sha1(repr(self.measured_us).encode()).hexdigest()
        return (self.hw_name, digest, len(self.measured_us))

    def as_dict(self) -> dict[int, float]:
        return dict(self.measured_us)


def apply_profile(graph: OpGraph, table: ProfileTable) -> None:
    """Hydrate ``measured_us`` on every timed node and stamp the graph with
    the table's fingerprint (read by the plan/executable cache keys)."""
    for op_id, us in table.measured_us:
        graph.nodes[op_id].cost.measured_us = us
    graph.calibration_fp = table.fingerprint


def detach_profile(graph: OpGraph) -> ProfileTable | None:
    """Strip measured timings off the graph, returning them as a table
    (or ``None`` if the graph carries no measurements)."""
    measured = tuple(
        (n.op_id, n.cost.measured_us)
        for n in graph if n.cost.measured_us is not None
    )
    fp = graph.calibration_fp
    for n in graph:
        n.cost.measured_us = None
    graph.calibration_fp = None
    if not measured:
        return None
    hw_name = fp[0] if fp else ""
    return ProfileTable(hw_name=hw_name, measured_us=measured)


# Operator kinds that engage the MXU / systolic pipeline — the paper's
# compute-intensive population at framework granularity.
_COMPUTE_KINDS = frozenset(
    {OpKind.GEMM, OpKind.CONV, OpKind.ATTENTION, OpKind.SCAN})
# Analytic FLOP/byte below which even an MXU kind is bandwidth-bound
# (skinny batch-1 GEMMs, tiny score matmuls).
COMPUTE_AI_FLOOR = 16.0


def _timed(fn: Any, args: list, repeats: int) -> tuple[Any, float]:
    """Run ``fn(*args)`` ``repeats`` times; return the last result and the
    mean time per run in µs."""
    out = None
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / repeats * 1e3
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args)
    return out, (time.perf_counter() - t0) / repeats * 1e6


class ModelProfiler:
    """Computes per-op profiles for an :class:`OpGraph`."""

    def __init__(self, hw: HardwareSpec = V5E):
        self.hw = hw

    # -- analytic ------------------------------------------------------------
    def roofline_us(self, cost: OpCost) -> float:
        """max(compute time, memory time, kernel floor) — roofline estimate."""
        t_c = cost.flops / self.hw.peak_flops
        t_m = cost.bytes_total / self.hw.hbm_bw
        return max(max(t_c, t_m) * 1e6, self.hw.min_kernel_us)

    def classify(self, node: OpNode) -> IntensityClass:
        """Kind-aware intensity classification (paper §3.3, see module doc)."""
        if (node.kind in _COMPUTE_KINDS
                and node.cost.arithmetic_intensity() >= COMPUTE_AI_FLOOR):
            return IntensityClass.COMPUTE
        return node.cost.intensity(self.hw.machine_balance)

    def profile(self, graph: OpGraph) -> dict[int, OpProfile]:
        out: dict[int, OpProfile] = {}
        for node in graph:
            est = node.cost.measured_us
            if est is None:
                est = self.roofline_us(node.cost)
            out[node.op_id] = OpProfile(
                cost=node.cost,
                intensity=self.classify(node),
                est_us=max(est, 1e-3),
            )
        return out

    # -- measured (one inference pass, paper §3.2) ----------------------------
    def measure(
        self,
        graph: OpGraph,
        inputs: Mapping[int, Any],
        repeats: int = 3,
    ) -> ProfileTable:
        """Execute the graph once op-by-op, timing each payload.

        ``inputs`` maps INPUT-node op_ids to concrete tensors.  The paper's
        single profiling run: each payload runs once to warm up, then
        ``repeats`` times under the clock — CUDA events on the card,
        ``perf_counter`` on the CPU.  Pure: the graph is NOT mutated —
        hydrate the returned table with :func:`apply_profile` (or let the calibration
        cache on :class:`repro_torch.core.Session` do it).
        """
        values: dict[int, Any] = dict(inputs)
        measured: list[tuple[int, float]] = []
        for i in graph.topological_order():
            node = graph.nodes[i]
            if node.fn is None:
                if i not in values:
                    raise ValueError(f"input op {node.name} has no value bound")
                continue
            args = [values[p] for p in node.inputs]
            args += list(node.meta.get("consts", ()))
            node.fn(*args)                      # warm-up run
            values[i], us = _timed(node.fn, args, repeats)
            measured.append((i, us))
        return ProfileTable(hw_name=self.hw.name, measured_us=tuple(measured))

    def profile_measured(
        self,
        graph: OpGraph,
        inputs: Mapping[int, Any],
        repeats: int = 3,
    ) -> dict[int, OpProfile]:
        """One-call convenience: measure, hydrate the graph, return profiles
        (measured ops carry ``est_us = measured_us``; inputs stay analytic)."""
        apply_profile(graph, self.measure(graph, inputs, repeats=repeats))
        return self.profile(graph)


# -- analytic cost constructors (used by models when emitting graphs) --------

def gemm_cost(m: int, k: int, n: int, dtype_bytes: int = 2, batch: int = 1) -> OpCost:
    flops = 2.0 * batch * m * k * n
    br = batch * (m * k + k * n) * dtype_bytes
    bw = batch * m * n * dtype_bytes
    # VMEM working set: one MXU tile pass — bounded by operand tiles, not the
    # whole tensor; approximate with min(whole operands, 3 × 128-wide tiles).
    tile = 128
    vmem = dtype_bytes * min(
        batch * (m * k + k * n + m * n),
        (m * tile + tile * n + m * n) if k > tile else batch * (m * k + k * n + m * n),
    )
    # occupancy: output parallelism vs the device's lane budget (~512k)
    occ = min(1.0, batch * m * n / float(1 << 19))
    return OpCost(flops=flops, bytes_read=br, bytes_written=bw,
                  vmem_bytes=float(vmem), occupancy=occ)


def elementwise_cost(numel: int, dtype_bytes: int = 2, n_in: int = 1, flops_per_elem: float = 1.0) -> OpCost:
    return OpCost(
        flops=flops_per_elem * numel,
        bytes_read=float(n_in * numel * dtype_bytes),
        bytes_written=float(numel * dtype_bytes),
        vmem_bytes=float(min((n_in + 1) * numel * dtype_bytes, 8 * 2**20)),
        occupancy=min(1.0, numel / float(1 << 21)),
    )


def norm_cost(numel: int, dtype_bytes: int = 2) -> OpCost:
    return OpCost(
        flops=5.0 * numel,
        bytes_read=float(numel * dtype_bytes),
        bytes_written=float(numel * dtype_bytes),
        vmem_bytes=float(min(2 * numel * dtype_bytes, 4 * 2**20)),
        occupancy=min(1.0, numel / float(1 << 21)),
    )


def gather_cost(rows: int, width: int, dtype_bytes: int = 2) -> OpCost:
    n = rows * width
    return OpCost(
        flops=0.0,
        bytes_read=float(n * dtype_bytes + rows * 4),
        bytes_written=float(n * dtype_bytes),
        vmem_bytes=float(min(n * dtype_bytes, 4 * 2**20)),
        occupancy=min(1.0, n / float(1 << 21)),
    )


def attention_cost(b: int, q: int, kv: int, h: int, d: int, kvh: int, dtype_bytes: int = 2) -> OpCost:
    flops = 4.0 * b * h * q * kv * d  # QK^T + PV
    br = float(dtype_bytes * b * (q * h * d + 2 * kv * kvh * d))
    bw = float(dtype_bytes * b * q * h * d)
    vmem = float(dtype_bytes * (128 * d + 2 * 512 * d + 128 * 512))  # flash tiles
    occ = min(1.0, b * h * q * d / float(1 << 19))
    return OpCost(flops=flops, bytes_read=br, bytes_written=bw, vmem_bytes=vmem,
                  occupancy=occ)


def scan_cost(b: int, t: int, d: int, state: int, dtype_bytes: int = 2) -> OpCost:
    """Linear recurrence (RWKV/Mamba): ~10 flops/elem/state, streaming reads."""
    flops = 10.0 * b * t * d * max(state, 1)
    br = float(dtype_bytes * b * t * d * 4)
    bw = float(dtype_bytes * b * t * d)
    return OpCost(flops=flops, bytes_read=br, bytes_written=bw,
                  vmem_bytes=float(dtype_bytes * min(b, 8) * d * max(state, 1) * 4),
                  occupancy=min(1.0, b * d / float(1 << 19)))


def summarize(graph: OpGraph, profiles: dict[int, OpProfile]) -> dict[str, float]:
    n_c = sum(1 for p in profiles.values() if p.intensity is IntensityClass.COMPUTE)
    return {
        "ops": float(len(graph)),
        "compute_ops": float(n_c),
        "memory_ops": float(len(graph) - n_c),
        "total_flops": float(sum(p.cost.flops for p in profiles.values())),
        "total_bytes": float(sum(p.cost.bytes_total for p in profiles.values())),
        "sum_est_us": float(sum(p.est_us for p in profiles.values())),
    }
