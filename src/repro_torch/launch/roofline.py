"""Roofline analysis: the JAX package's ``launch/roofline.py``.

Per (arch × shape × mesh) cell, three roofline terms:

    compute term    = FLOPs / (chips × peak_FLOP/s)
    memory term     = bytes / (chips × HBM_bw)
    collective term = collective_bytes_per_device / link_bw

:func:`roofline_terms` defaults to the reference's TPU v5e spec, so the two
packages agree number for number; a bound for the card passes
``hw=core.profiler.H100_SXM`` (or ``hardware_for_name`` of the card's
name).  :func:`analyse_cell` takes the compute and memory terms from the
analytic model (:func:`.analytic_cost.cell_cost`) and the collective term
from the dry-run's count (:func:`.dryrun.lower_cell`: rank 0's bytes on
the fake production mesh), and cross-checks the dry-run's FLOPs against
the analytic count on one basis: per-device FLOPs × chips / analytic.

:func:`_block_record` counts ONE block (train: fwd+bwd; prefill: fwd;
decode: one step) on a mesh, with :func:`_single_chunk_attention` forcing
``chunked_attention`` to one chunk.  The reference needs it because XLA's
``cost_analysis`` counts a ``lax.scan`` body once; the port's count runs
every layer, so ``analyse_cell`` does not call it (nor does the
reference's).  ``_attn_bytes_inflation`` is the reference's estimate of
the fp32 [b,h,s,t] round-trips a single-chunk count claims and a flash
kernel keeps on chip.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Any

import torch

from ..configs import SHAPES, cell_applicable, get_config, list_archs
from ..configs.base import ModelConfig, ParallelConfig, ShapeCell
from ..core.profiler import V5E, HardwareSpec


# ---------------------------------------------------------------- block costs

@contextlib.contextmanager
def _single_chunk_attention():
    from ..models import attention as att
    prev = att._CHUNK_OVERRIDE
    att._CHUNK_OVERRIDE = "single"
    try:
        yield
    finally:
        att._CHUNK_OVERRIDE = prev


def _block_record(cfg: ModelConfig, cell: ShapeCell, mesh, kind: str,
                  windows, single_chunk: bool) -> dict[str, float]:
    """Run ONE block of ``kind`` on meta ``DTensor``s over ``mesh`` (a
    fake world of its size must be up) and return {flops, bytes,
    collective_bytes} per device."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models.attention import init_cache
    from ..models.ssm import mamba_state_init, rwkv_state_init
    from ..models.transformer import block_seq, block_step, init_block
    from ..parallel.sharding import (activation_rules, param_shardings,
                                     place, place_tree)
    from ..utils import logical_axis_rules
    from ..utils.tree import tree_leaves, tree_map
    from .hlo_analysis import StepCounter

    b = cell.global_batch
    s = cell.seq_len if cell.step != "decode" else 1
    p_shapes = init_block(torch.Generator(), cfg, kind, device="meta")
    p = place_tree(p_shapes, param_shardings(mesh, p_shapes), mesh)

    def replicated(t):
        return place(t, mesh, (None,) * t.dim())
    x = replicated(torch.empty((b, s, cfg.d_model), dtype=cfg.dtype,
                               device="meta"))
    win = windows[0] if windows and windows[0] > 0 else None
    rules = activation_rules(mesh, cell)
    ctx = _single_chunk_attention() if single_chunk else contextlib.nullcontext()
    counter = StepCounter()
    with logical_axis_rules(rules, mesh), implicit_replication(), ctx:
        positions = torch.arange(s, device="meta")[None].expand(b, s)
        if cell.step == "train":
            leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
            x.requires_grad_(True)
            with counter:
                y, _, aux = block_seq(p, x, cfg, positions, win, False, kind)
                loss = y.float().mean() + (0.0 if aux is None else aux)
                torch.autograd.grad(loss, leaves + [x], allow_unused=True)
        elif cell.step == "prefill":
            with torch.no_grad(), counter:
                block_seq(p, x, cfg, positions, win, False, kind)
        else:  # decode
            length = cell.seq_len + cfg.meta_tokens
            if kind == "rwkv":
                cache = rwkv_state_init(cfg, b, device="meta")
            else:
                cache = init_cache(cfg, b, length, device="meta")
                if kind == "hybrid":
                    conv, m_h = mamba_state_init(cfg, b, device="meta")
                    cache = {"kv": cache, "mamba_conv": conv, "mamba_h": m_h}
            cache = tree_map(replicated, cache)
            pos = replicated(torch.empty((b,), dtype=torch.int32,
                                         device="meta"))
            with torch.no_grad(), counter:
                block_step(p, x, cache, pos, cfg, win, False, kind)
    return {"flops": counter.flops, "bytes": counter.bytes_accessed,
            "collective_bytes": counter.collectives().total_bytes}


def _attn_bytes_inflation(cfg: ModelConfig, cell: ShapeCell) -> float:
    """fp32 [b,h,s,t] probability round-trips that single-chunk lowering
    claims but real flash keeps in VMEM (3 passes: logits write, read for
    softmax-normalize, p read for PV)."""
    if cell.step == "decode":
        return 0.0
    b, s = cell.global_batch, cell.seq_len + cfg.meta_tokens
    if cfg.family == "ssm":
        return 0.0
    h = cfg.n_heads
    per_layer = 3.0 * 4.0 * b * h * s * s
    if cell.step == "train":
        per_layer *= 2.5      # bwd recompute + ds/dp traffic
    return per_layer


# ---------------------------------------------------------------- terms

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


# ---------------------------------------------------------------- driver

def analyse_cell(arch: str, shape_id: str, multi_pod: bool = False,
                 pcfg: ParallelConfig | None = None,
                 hw: HardwareSpec = V5E) -> dict[str, Any]:
    from .analytic_cost import cell_cost
    from .dryrun import lower_cell, n_chips
    cfg = get_config(arch)
    cell = SHAPES[shape_id]
    ok, reason = cell_applicable(cfg, cell)
    if not ok:
        return {"arch": arch, "shape": shape_id, "multi_pod": multi_pod,
                "status": "SKIP", "reason": reason}

    rec = lower_cell(arch, shape_id, multi_pod=multi_pod, pcfg=pcfg)
    if rec.get("status") != "OK":
        return rec
    chips = n_chips(multi_pod)

    # compute/memory terms: analytic model (see analytic_cost.py for why);
    # collective term: the dry-run's per-device count
    remat = (pcfg or ParallelConfig()).remat != "none" and cell.step == "train"
    ac = cell_cost(cfg, cell, remat=remat)
    coll = rec["collectives"]["total_bytes_per_device"]

    mf = model_flops(cfg, cell)
    terms = roofline_terms(ac.flops, ac.bytes, coll, chips, hw)
    flops_per_dev = rec["cost"].get("flops", 0.0)
    rec.update(
        analytic={"flops": ac.flops, "bytes": ac.bytes, **ac.detail},
        hlo_flops_per_device=flops_per_dev,
        hlo_crosscheck_ratio=(flops_per_dev * chips / ac.flops
                              if ac.flops else 0.0),
        model_flops=mf,
        useful_flops_ratio=mf / ac.flops if ac.flops else 0.0,
        roofline=terms,
    )
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    # §Perf hillclimb knobs (flags REPRO_* come via the environment)
    ap.add_argument("--no-fsdp", action="store_true",
                    help="replicate params over dp axes (inference cells)")
    ap.add_argument("--no-tp", action="store_true",
                    help="disable tensor parallelism (tiny-model cells)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="Megatron-SP residual-stream sharding")
    ap.add_argument("--ep2d", action="store_true",
                    help="experts sharded data×model (whole-expert ownership)")
    ap.add_argument("--remat", default="block", choices=["none", "block"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--tag", default=None, help="label recorded with --out")
    args = ap.parse_args(argv)
    pcfg = ParallelConfig(fsdp=not args.no_fsdp, remat=args.remat,
                          tensor_parallel=not args.no_tp,
                          sequence_parallel=args.seq_parallel,
                          expert_2d=args.ep2d,
                          grad_compression=args.compression)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    for arch in archs:
        for shape_id in shapes:
            rec = analyse_cell(arch, shape_id, multi_pod=args.multi_pod,
                               pcfg=pcfg)
            if args.tag:
                rec["tag"] = args.tag
            r = rec.get("roofline", {})
            print(f"[roofline] {arch} × {shape_id}: {rec['status']} "
                  + (f"dominant={r.get('dominant')} "
                     f"frac={r.get('roofline_fraction', 0):.3f} "
                     f"c/m/x={r.get('compute_s', 0):.4f}/"
                     f"{r.get('memory_s', 0):.4f}/{r.get('collective_s', 0):.4f}s"
                     if r else ""))
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
