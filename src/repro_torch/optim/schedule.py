"""LR schedules: cosine with warmup, and WSD (warmup-stable-decay, MiniCPM).

The JAX package's ``optim/schedule.py``.  ``step`` may be a tensor (the
optimizer's int32 step on its device, as the train step passes it) or a
Python number; the result is a float32 tensor on the step's device.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine_schedule(step, base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = base_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def wsd_schedule(step, base_lr: float, warmup: int, stable: int, decay: int,
                 min_ratio: float = 0.01) -> torch.Tensor:
    """MiniCPM's warmup-stable-decay: linear warmup, flat, exp decay tail."""
    step = _step(step)
    warm = base_lr * step / max(warmup, 1)
    in_decay = step > (warmup + stable)
    t = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
    dec = base_lr * torch.pow(torch.tensor(min_ratio, dtype=torch.float32,
                                           device=step.device), t)
    return torch.where(step < warmup, warm,
                       torch.where(in_decay, dec,
                                   torch.full_like(step, base_lr)))
