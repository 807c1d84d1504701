"""The control of the correctness check: the plain reference computed one
precision below the configuration's (float8 e4m3 operands for a bfloat16
configuration), put in the program's place, on the same weights and the
same sampled prompts a run of the cell checks.  Its numbers have to come
out above the cell's limits.  The benchmark's own runs never run it.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed, with each number beside the cell's limit.
"""
from __future__ import annotations

import json
import pathlib
import sys

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402
from portbench.reference.common import exact_fp32, logits  # noqa: E402


def control_checks(cell: harness.Cell, seed: int, device: str = "cuda",
                   quant: str = "fp8") -> dict:
    """The check's numbers with the ``quant`` reference in the program's
    place, at the cell's sizes and on the requests a run with ``seed``
    samples."""
    cfg, traffic = cell.cfg, cell.traffic
    weights = harness.make_weights(cfg, seed, device)
    pool = harness.make_pool(cfg, traffic, seed, device)
    ids = torch.cat([pool[j % pool.shape[0]]
                     for j in harness.sample_indices(traffic, seed)])
    ref = harness.reference_module(cfg)
    got = []
    for r0 in range(0, ids.shape[0], 8):
        h = ref.hidden(cfg, weights, ids[r0:r0 + 8], quant)
        with exact_fp32(), torch.no_grad():
            got += [logits(cfg, weights, row, quant) for row in h]
    return harness.compare(cfg, weights, ids, torch.stack(got))


def main(argv: list[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = control_checks(cell, seed)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": "fp8",
                          "checks": {k: {"value": v,
                                         "limit": cell.limits[k]}
                                     for k, v in checks.items()}}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
