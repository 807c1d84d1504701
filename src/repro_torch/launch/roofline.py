"""Roofline terms: the pure half of the JAX package's ``launch/roofline.py``.

    compute term    = FLOPs / (chips × peak_FLOP/s)
    memory term     = bytes / (chips × HBM_bw)
    collective term = collective_bytes_per_device / link_bw

:func:`roofline_terms` defaults to the reference's TPU v5e spec, so the two
packages agree number for number; a bound for the card passes
``hw=core.profiler.H100_SXM`` (or ``hardware_for_name`` of the card's
name).  The FLOPs and bytes come from :func:`.analytic_cost.cell_cost`.

Not ported (ROADMAP A10): the lowering half, which corrects XLA's
``cost_analysis`` block by block from compiled dry-run artifacts, and the
command line that drives it over a production mesh.
"""
from __future__ import annotations

from ..configs.base import ModelConfig, ShapeCell
from ..core.profiler import V5E, HardwareSpec


def roofline_terms(flops: float, bytes_: float, coll_bytes_per_dev: float,
                   chips: int, hw: HardwareSpec = V5E) -> dict[str, float]:
    compute_s = flops / (chips * hw.peak_flops)
    memory_s = bytes_ / (chips * hw.hbm_bw)
    collective_s = coll_bytes_per_dev / hw.ici_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return {**terms, "dominant": dominant,
            "roofline_fraction": compute_s / bound if bound > 0 else 0.0,
            "step_time_lower_bound_s": bound}


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """6·N_active·D for train, 2·N_active·D for inference (D = tokens)."""
    n = cfg.n_active_params()
    if cell.step == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.step == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch          # one token per sequence
