"""Gradient compression with error feedback: the JAX package's
``optim/compression.py``.

Modes: ``int8`` (per-tensor int8 quantisation, the residual carried to the
next step) and ``topk`` (magnitude sparsification to the top 1% with
error feedback).  The train step applies them to the grads before AdamW;
the error state sits beside the optimizer state.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


class CompressionState(NamedTuple):
    error: Any   # residual tree (fp32), None when compression is off


def init_compression(params, mode: str) -> CompressionState:
    if mode == "none":
        return CompressionState(error=None)
    return CompressionState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-8) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127)
    return q * scale


def _topk_mask(g: torch.Tensor, k_frac: float = 0.01) -> torch.Tensor:
    flat = torch.abs(g.reshape(-1))
    k = max(1, int(flat.numel() * k_frac))
    thresh = torch.topk(flat, k).values[-1]
    return torch.where(torch.abs(g) >= thresh, g, torch.zeros_like(g))


@torch.no_grad()
def compress_grads(grads, state: CompressionState, mode: str):
    """Returns (compressed_grads, new_state).  Error feedback: the part of
    the gradient destroyed by compression is added back next step."""
    if mode == "none" or state.error is None:
        return grads, state

    def one(g, e):
        gf = g.float() + e
        if mode == "int8":
            sent = _int8_roundtrip(gf)
        elif mode == "topk":
            sent = _topk_mask(gf)
        else:
            raise ValueError(f"unknown compression mode {mode}")
        return sent.to(g.dtype), gf - sent

    flat_g, spec = tree_flatten(grads)
    out = [one(g, e) for g, e in zip(flat_g, tree_leaves(state.error))]
    return (tree_unflatten(spec, [o[0] for o in out]),
            CompressionState(error=tree_unflatten(spec, [o[1] for o in out])))
