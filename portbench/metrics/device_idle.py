"""device_idle: the share of the traced window's wall time in which no
kernel ran: 1 - the union of all kernel intervals over the window (%)."""


def read(ctx: dict) -> float | None:
    trace = ctx.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - trace["busy_s"] / trace["window_s"])
