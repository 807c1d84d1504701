"""expert_ms: the device time per forward of moe_gemm's kernels
(``csrc/moe.cu``), the held experts' MLP of the expert-parallel layer,
among the traced window's top device operations (ms): the wgmma route's
two stages (``expert_wgmma_kernel<true, NT>``, gate and up;
``<false, NT>``, down), or the simple and fp32 routes' stages.  The
harness lists the ten largest operations only, so a stage that falls
below the tenth is not counted, and nothing is read where no such kernel
is listed.

Its share of the roofline needs the routed rows of each held expert in
each layer, which only the program counts (the counter
``moe.held_counts``): with random weights the tokens of a layer crowd
onto a few experts (up to 504 of 512 rows on one), so the rows that the
routing is expected to send (N · top_k · held / E) say too little.
``scripts/torch_trace_cell.py`` reads the counts and prints the share."""
import re

# the kernels of csrc/moe.cu that compute the expert MLP: the wgmma
# route's two stages, the simple and fp32 routes' stages
KERNELS = re.compile(r"expert_wgmma_kernel|expert_gemm_kernel")


def device_seconds(device_ops) -> float:
    """Seconds per forward of the listed moe_gemm kernels."""
    return sum(s for name, s in device_ops if KERNELS.search(name))


def read(ctx: dict) -> float | None:
    trace = ctx.get("trace")
    if not trace:
        return None
    busy = device_seconds(trace["device_ops"])
    return 1e3 * busy if busy > 0 else None
