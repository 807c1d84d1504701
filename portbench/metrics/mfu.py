"""mfu: the forward's model operations (the family's own count from the
configuration and the cell's shapes) over the mean forward time of the
run's untraced window times the card's bf16 peak (%).  The window is the
one ``forward_ms`` reads; the profiler's own cost stays out of it."""


def read(ctx: dict) -> float | None:
    forward_s = ctx["forward_s"]
    flops = ctx["family"].model_flops(ctx["cfg"], ctx["batch"], ctx["seq"])
    return 100.0 * flops / (forward_s * ctx["peaks"]["bf16_flops"])
