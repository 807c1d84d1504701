"""Cross-entropy losses: the JAX package's ``models/losses.py``.

The gold logit is a gather, which equals the reference's one-hot
contraction exactly (one nonzero term a row); over ``DTensor`` logits
split along the vocab the gather reads them made whole there first
(``whole_dim``), where GSPMD reshards the reference's on its own.  :func:`chunked_softmax_xent`
fuses the head matmul into a loop over sequence chunks, so the full
``[B,S,V]`` fp32 logits are never made at once, in the forward or the
backward; the LM loss takes it under the ``chunked_ce`` flag
(:mod:`repro_torch.flags`), as the JAX package's does.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..utils.sharding_ctx import whole_dim
from .layers import unembed


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy.  logits: [B,S,V] fp32; labels: [B,S] int."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(whole_dim(logits, -1), -1,
                        labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def _chunk_xent_sum(x: torch.Tensor, head_table: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Summed token cross-entropy of one chunk, its logits made here."""
    logits = unembed({"table": head_table}, x)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(whole_dim(logits, -1), -1,
                        labels.long()[..., None])[..., 0]
    return (lse - gold).sum()


def chunked_softmax_xent(x: torch.Tensor, head_table: torch.Tensor,
                         labels: torch.Tensor,
                         s_chunk: int = 512) -> torch.Tensor:
    """Cross-entropy with the head matmul inside a loop over sequence
    chunks of ``s_chunk`` halved until it divides S, as the JAX package
    chooses them.  x: [B,S,d] final hidden states; head_table: [V,d];
    labels: [B,S].  Under autograd each chunk is checkpointed: its fp32
    logits are freed after the forward and made again in the backward, so
    one chunk's logits are alive at a time there too (a plain loop would
    keep every chunk's for the backward, the whole ``[B,S,V]``)."""
    b, s, _ = x.shape
    sc = min(s_chunk, s)
    while s % sc:
        sc //= 2
    total = x.new_zeros((), dtype=torch.float32)
    for s0 in range(0, s, sc):
        total = total + torch.utils.checkpoint.checkpoint(
            _chunk_xent_sum, x[:, s0:s0 + sc], head_table,
            labels[:, s0:s0 + sc], use_reentrant=False)
    return total / (b * s)
