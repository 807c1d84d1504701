"""overlap_share: the share of the device's busy time during which two or
more kernels ran at once, from the union of the kernels' intervals in the
traced window of back-to-back forwards (%)."""


def read(ctx: dict) -> float | None:
    trace = ctx.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * trace["overlap_s"] / trace["busy_s"]
