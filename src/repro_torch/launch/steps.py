"""Step functions of the port: the JAX package's ``launch/steps.py``.

``make_train_step``: loss → grad → (optional compression) → cosine LR →
AdamW.  ``make_prefill_step`` / ``make_decode_step``: the serving steps.
Grads are taken with ``torch.autograd.grad`` over the param leaves; the
params the step returns come out of the optimizer with ``requires_grad``
off, so serving a trained tree builds no graph.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ParallelConfig, ShapeCell
from ..models import Model
from ..optim import AdamWState, adamw_update, compress_grads
from ..optim.schedule import cosine_schedule
from ..utils.tree import tree_flatten, tree_unflatten


def loss_and_grads(model: Model, params, batch, seed: int = 0,
                   remat: bool = False):
    """(loss, metrics, grads): ``model.loss`` on ``batch`` and its grads, a
    tree like ``params`` (zeros for a leaf the loss does not read).  The
    router noise draws from a generator seeded with ``seed``."""
    leaves, spec = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    device = leaves[0].device
    # the meta device (the dry-run) has no generator; nothing is drawn there
    generator = torch.Generator(
        device="cpu" if device.type == "meta" else device).manual_seed(
            int(seed))
    loss, metrics = model.loss(tree_unflatten(spec, live), batch, generator,
                               remat=remat)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, live)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(spec, grads)


def make_train_step(model: Model, pcfg: ParallelConfig,
                    base_lr: float = 3e-4, warmup: int = 2000,
                    total_steps: int = 100_000,
                    on_grads: Callable[[], None] | None = None) -> Callable:
    """``train_step(params, opt_state, batch, seed) → (params, opt_state,
    metrics)``.  ``opt_state`` is an :class:`AdamWState`, or ``(AdamWState,
    CompressionState)`` when the grads are compressed.  ``on_grads`` (if
    given) runs between the backward and the optimizer, e.g. to record a
    CUDA event that splits the step's time."""
    remat = pcfg.remat != "none"

    def train_step(params, opt_state, batch, seed):
        loss, metrics, grads = loss_and_grads(model, params, batch, seed,
                                              remat)
        if on_grads is not None:
            on_grads()
        has_comp = not isinstance(opt_state, AdamWState)
        comp_state = None
        if has_comp:
            adam, comp_state = opt_state
        else:
            adam = opt_state
        if pcfg.grad_compression != "none" and comp_state is not None:
            grads, comp_state = compress_grads(grads, comp_state,
                                               pcfg.grad_compression)
        lr = cosine_schedule(adam.step, base_lr, warmup=warmup,
                             total=total_steps)
        new_params, new_adam, opt_metrics = adamw_update(grads, adam, params,
                                                         lr)
        new_opt = (new_adam, comp_state) if has_comp else new_adam
        return new_params, new_opt, {**metrics, **opt_metrics, "loss": loss}

    return train_step


def make_prefill_step(model: Model, cell: ShapeCell) -> Callable:
    cache_len = cell.seq_len + model.cfg.meta_tokens

    def prefill_step(params, inputs):
        return model.prefill(params, inputs, cache_len=cache_len)

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(params, caches, token, pos):
        return model.decode(params, token, caches, pos)

    return decode_step
