"""gemm_roofline: the least time of the forward's weight products (the
family's own list; each bound by its operations or its bytes) over the
time per forward in which a kernel of the class ``weight_gemm`` ran
(the union of their intervals in the traced window) (%).  Nothing is read
where no kernel of the class ran."""
from portbench.families.common import least_seconds


def read(ctx: dict) -> float | None:
    trace = ctx.get("trace")
    if not trace:
        return None
    busy = trace["class_busy_s"].get("weight_gemm", 0.0)
    if busy <= 0:
        return None
    least = least_seconds(ctx["family"].products(ctx["cfg"], ctx["batch"],
                                                 ctx["seq"]),
                          ctx["cfg"]["dtype"], ctx["peaks"])
    return 100.0 * least / (busy / trace["n_forwards"])
