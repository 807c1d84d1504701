"""Multi-pod dry-run: run EVERY (arch × shape × mesh) cell's step on the
production mesh without a device, the JAX package's ``launch/dryrun.py``.

The reference lowers and compiles each cell on 512 host placeholder
devices.  The port runs it on a fake process group of 256 or 512 ranks
(:func:`.mesh.fake_world`), in this one process as rank 0: params,
optimizer moments, inputs and decode caches are meta ``DTensor``s laid out
by the sharding rules, and the step runs under the activation rules, so
``DTensor`` plans every redistribution as it would on the real mesh while
no byte is allocated.  A :class:`.hlo_analysis.StepCounter` reckons rank
0's collectives, FLOPs and memory.

A 2×16×16 cell runs on the mesh's flattened form, (pod·data)×model =
32×16 with the pod-major pod·data dim named ``data``.  Every rule shards
pod and data together (the data-parallel dims), so the rules on 32×16
give the 2×16×16 specs with ``("pod", "data")`` read as one dim (the same
ranks hold the same slices), and ``DTensor`` plans one collective over the
32 ranks where on three mesh dims it plans two in a row, after a strategy
search over three mesh dims that makes a train cell more than ten times
slower on one CPU core.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \
        --shape decode_32k [--multi-pod] [--out results.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Per cell this prints and records the per-device memory (the argument and
output bytes of the local shards, and the counter's peak of live
temporaries), the per-device FLOPs, and the collectives by kind.  The
port's layers are a Python loop, so each layer's collectives are counted
where they run: ``scan_depth_multiplier`` is 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Any

import torch

from ..configs import SHAPES, cell_applicable, get_config, list_archs
from ..configs.base import ParallelConfig
from ..models import Model
from ..optim import adamw_init
from ..parallel.sharding import (activation_rules, batch_specs, cache_specs,
                                 param_shardings, place, place_tree)
from ..utils import logical_axis_rules
from ..utils.tree import tree_leaves
from .hlo_analysis import StepCounter, cost_dict, memory_dict
from .mesh import fake_world
from .steps import make_decode_step, make_prefill_step, make_train_step


def n_chips(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def cell_mesh(multi_pod: bool):
    """The dry-run's mesh (a fake world of its size must be up): 16×16, or
    the 2×16×16 production mesh flattened to 32×16 (module docstring)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (32 if multi_pod else 16, 16),
                            mesh_dim_names=("data", "model"))


def run_cell(model: Model, cell, mesh, pcfg: ParallelConfig):
    """The cell's step on meta ``DTensor``s over ``mesh`` under the rules
    → (arguments, outputs, counter)."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = model.cfg
    params_shapes = model.init_shapes()
    param_sp = param_shardings(mesh, params_shapes, fsdp=pcfg.fsdp,
                               tensor_parallel=pcfg.tensor_parallel,
                               expert_2d=pcfg.expert_2d)
    params = place_tree(params_shapes, param_sp, mesh)
    rules = activation_rules(mesh, cell, tensor_parallel=pcfg.tensor_parallel,
                             sequence_parallel=pcfg.sequence_parallel,
                             expert_2d=pcfg.expert_2d)
    inputs = model.input_specs(cell)
    input_sp = batch_specs(mesh, cfg, inputs, cell,
                           tensor_parallel=pcfg.tensor_parallel)
    inputs = {k: place(v, mesh, input_sp[k]) for k, v in inputs.items()}
    with logical_axis_rules(rules, mesh), implicit_replication():
        if cell.step == "train":
            # mu/nu inherit the param shardings (ZeRO-3), step replicated
            opt = adamw_init(params)
            args = [params, opt, inputs]
            step = make_train_step(model, pcfg)
            with StepCounter() as counter:
                out = step(params, opt, inputs, 0)
        elif cell.step == "prefill":
            args = [params, inputs]
            step = make_prefill_step(model, cell)
            with torch.no_grad(), StepCounter() as counter:
                out = step(params, inputs)
        else:  # decode: the caches are written in place, as donated there
            caches = model.decode_state_specs(cell)
            caches = place_tree(caches, cache_specs(mesh, cfg, caches, cell),
                                mesh)
            args = [params, caches, inputs]
            step = make_decode_step(model)
            with torch.no_grad(), StepCounter() as counter:
                out = step(params, caches, inputs["token"], inputs["pos"])
    return tree_leaves(args), tree_leaves(out), counter


def lower_cell(arch: str, shape_id: str, multi_pod: bool = False,
               pcfg: ParallelConfig | None = None) -> dict[str, Any]:
    """Run one cell on the fake production mesh → the dry-run record."""
    cfg = get_config(arch)
    cell = SHAPES[shape_id]
    ok, reason = cell_applicable(cfg, cell)
    if not ok:
        return {"arch": arch, "shape": shape_id, "multi_pod": multi_pod,
                "status": "SKIP", "reason": reason}
    pcfg = pcfg or ParallelConfig()
    chips = n_chips(multi_pod)
    t0 = time.time()
    with fake_world(chips):
        mesh = cell_mesh(multi_pod)
        args, outs, counter = run_cell(Model(cfg), cell, mesh, pcfg)
    coll = counter.collectives()
    return {
        "arch": arch, "shape": shape_id, "multi_pod": multi_pod,
        "status": "OK", "n_chips": chips,
        "lower_s": round(time.time() - t0, 1),
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "memory": memory_dict(counter, args, outs),
        "cost": cost_dict(counter),
        "collectives": {
            "bytes_by_kind": coll.bytes_by_kind,
            "count_by_kind": coll.count_by_kind,
            "total_bytes_per_device": coll.total_bytes,
            "scan_depth_multiplier": 1,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="all arch×shape×mesh cells")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str, bool]] = []
    if args.all:
        for arch in list_archs():
            for shape_id in SHAPES:
                for mp in (False, True):
                    cells.append((arch, shape_id, mp))
    else:
        archs = [args.arch] if args.arch else list_archs()
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s, args.multi_pod) for a in archs for s in shapes]

    failures = 0
    for arch, shape_id, mp in cells:
        tag = f"{arch} × {shape_id} × {'2x16x16' if mp else '16x16'}"
        try:
            rec = lower_cell(arch, shape_id, multi_pod=mp)
        except Exception as e:
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape_id, "multi_pod": mp,
                   "status": "FAIL", "error": f"{type(e).__name__}: {e}"}
            failures += 1
        print(f"[dryrun] {tag}: {rec['status']}"
              + (f" mem={rec.get('memory')}" if rec.get("memory") else "")
              + (f" flops={rec.get('cost', {}).get('flops')}" if rec.get("cost") else ""),
              flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
