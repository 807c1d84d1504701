"""End-to-end training driver of the port: the JAX package's
``launch/train.py`` with the same flags, plus ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --full --steps 30 --batch 8 --seq 512 [--ckpt-dir DIR [--resume]]

config → model init (random weights from seed 0) → data pipeline → train
step (loss / grad / cosine LR / AdamW, optional grad compression) → async
checkpointing → heartbeat and straggler monitors.  ``--resume`` restarts
from the latest durable checkpoint and replays the data stream to the
exact step.  ``--device`` defaults to ``cuda``; without a card the trainer
raises (``--device cpu`` runs on the CPU).  The loss runs the plain route
(``Model(use_kernels=False)``), as the reference's trainer does: the CUDA
kernels have no backward.  ``--compression int8|topk`` compresses the grads
with error feedback; the reference's driver accepts the flag but keeps a
bare AdamW state, so its step never compresses (ROADMAP C18).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from ..checkpoint import Checkpointer, CheckpointSpec, latest_step
from ..configs import get_config
from ..configs.base import ParallelConfig
from ..data import make_dataset
from ..models import Model
from ..models.layers import check_device
from ..optim import adamw_init, init_compression
from ..runtime import HeartbeatMonitor, StragglerDetector
from ..utils.tree import tree_param_count
from .steps import make_train_step


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          ckpt_dir: str | None, resume: bool, ckpt_every: int = 20,
          compression: str = "none", log_every: int = 10,
          device: str = "cuda", n_layers: int | None = None) -> dict:
    """Train ``arch`` for ``steps`` steps → ``{first_loss, last_loss, steps,
    wall_s, n_params, losses, grad_norms, step_ms, fwd_bwd_ms, opt_ms,
    peak_mem_bytes}``.  ``n_layers`` cuts the depth (widths stay).  On the
    card ``step_ms`` is each step's device time from CUDA events,
    ``fwd_bwd_ms`` / ``opt_ms`` its split at the grads, and
    ``peak_mem_bytes`` the allocator's peak; on the CPU they are empty or
    None."""
    dev = check_device(device)
    cfg = get_config(arch, smoke=smoke)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    pcfg = ParallelConfig(grad_compression=compression, remat="none")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    opt_state = adamw_init(params)
    if compression != "none":
        opt_state = (opt_state, init_compression(params, compression))
    warmup = max(10, min(steps // 10, 200))
    timed = dev.type == "cuda"
    marks: list = []

    def on_grads():
        if timed:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
    step_fn = make_train_step(model, pcfg, base_lr=1e-3, warmup=warmup,
                              total_steps=max(steps, 1000),
                              on_grads=on_grads)

    data = make_dataset(cfg.vocab_size, seq, batch)
    ckpt = Checkpointer(CheckpointSpec(ckpt_dir)) if ckpt_dir else None
    start = 0
    if ckpt and resume:
        last = latest_step(ckpt_dir)
        if last is not None:
            state = ckpt.restore(last, {"params": params, "opt": opt_state,
                                        "data": {"step": 0}})
            params, opt_state = state["params"], state["opt"]
            data.load_state_dict({"step": int(state["data"]["step"])})
            start = last
            print(f"[train] resumed from step {last}")

    if timed:
        torch.cuda.reset_peak_memory_stats(dev)
    monitor = HeartbeatMonitor([0], time.monotonic)
    straggler = StragglerDetector()
    losses, grad_norms = [], []
    step_ms, fwd_bwd_ms, opt_ms = [], [], []
    t_total = time.perf_counter()
    for step in range(start, steps):
        t0 = time.perf_counter()
        batch_np = data.batch_at(step)
        batch_t = {k: torch.from_numpy(v).to(dev, torch.long)
                   for k, v in batch_np.items()}
        if timed:
            marks.clear()
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
        params, opt_state, metrics = step_fn(params, opt_state, batch_t, step)
        if timed:
            end.record()
        loss = float(metrics["loss"])
        grad_norm = float(metrics["grad_norm"])
        losses.append(loss)
        grad_norms.append(grad_norm)
        if timed:
            step_ms.append(begin.elapsed_time(end))
            fwd_bwd_ms.append(begin.elapsed_time(marks[0]))
            opt_ms.append(marks[0].elapsed_time(end))
        dt = time.perf_counter() - t0
        monitor.beat(0, dt)
        straggler.check(monitor)
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"grad_norm {grad_norm:.3f} {dt * 1e3:.0f}ms")
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state,
                                 "data": {"step": step + 1}})
    if ckpt:
        ckpt.save(steps, {"params": params, "opt": opt_state,
                          "data": {"step": steps}}, blocking=True)
    wall = time.perf_counter() - t_total
    result = {
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "steps": len(losses),
        "wall_s": wall,
    }
    print(f"[train] done: {result}")
    result.update(
        n_params=tree_param_count(params),
        losses=losses, grad_norms=grad_norms, step_ms=step_ms,
        fwd_bwd_ms=fwd_bwd_ms, opt_ms=opt_ms,
        peak_mem_bytes=torch.cuda.max_memory_allocated(dev) if timed
        else None)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = train(args.arch, args.smoke, args.steps, args.batch, args.seq,
                args.ckpt_dir, args.resume, compression=args.compression,
                device=args.device)
    return 0 if res["last_loss"] is not None and \
        np.isfinite(res["last_loss"]) else 1


if __name__ == "__main__":
    sys.exit(main())
