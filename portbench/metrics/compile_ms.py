"""compile_ms: the wall time of ``Session.compile`` on this run
(calibration, planning and capture), from the program's own
``CompiledModel.timings_ms["total"]``."""


def read(ctx: dict) -> float | None:
    return ctx["compile_timings_ms"].get("total")
