"""AdamW, by hand, with the JAX package's numerics (``optim/adamw.py``).

State: fp32 first and second moments per param leaf and an int32 step.
Global-norm clipping happens inside the update; bias correction uses the
float step; decoupled weight decay applies to matrices only (``ndim >=
2``); each leaf's update is computed in fp32 and cast back to the param's
dtype.  ``torch.optim.AdamW`` is not used: its decay applies to every
param and it does not clip.  Params, grads and moments are trees of the
port (nested dicts and lists) walked in ``jax.tree_util``'s leaf order.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..utils.tree import tree_flatten, tree_leaves, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor    # int32 scalar on the params' device
    mu: Any               # tree like params, fp32
    nu: Any               # tree like params, fp32


def adamw_init(params) -> AdamWState:
    leaves, spec = tree_flatten(params)

    def zeros():
        # zeros_like keeps a DTensor param's placements (ZeRO-3 moments)
        return tree_unflatten(spec, [torch.zeros_like(p, dtype=torch.float32)
                                     for p in leaves])
    device = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros(), nu=zeros())


def global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params,
                 lr: torch.Tensor | float, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: float = 1.0):
    """Returns (new_params, new_state, metrics)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step_f = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=step.device), step_f)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=step.device), step_f)

    def upd(g, m, v, p):
        g = g.float() * scale
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if p.dim() >= 2:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    flat_g, spec = tree_flatten(grads)
    out = [upd(g, m, v, p) for g, m, v, p in zip(
        flat_g, tree_leaves(state.mu), tree_leaves(state.nu),
        tree_leaves(params))]
    new_p, new_m, new_v = (tree_unflatten(spec, [o[i] for o in out])
                           for i in range(3))
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm}
