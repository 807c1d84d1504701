"""Cross-entropy losses: the JAX package's ``models/losses.py``.

The gold logit is a gather, which equals the reference's one-hot
contraction exactly (one nonzero term a row).  :func:`chunked_softmax_xent`
fuses the head matmul into a loop over sequence chunks, so the full
``[B,S,V]`` fp32 logits are never made at once; the LM loss takes it only
under the reference's ``chunked_ce`` flag, which the port leaves at its
default, off (ROADMAP A7).
"""
from __future__ import annotations

import torch

from .layers import unembed


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy.  logits: [B,S,V] fp32; labels: [B,S] int."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def chunked_softmax_xent(x: torch.Tensor, head_table: torch.Tensor,
                         labels: torch.Tensor,
                         s_chunk: int = 512) -> torch.Tensor:
    """Cross-entropy with the head matmul inside a loop over sequence
    chunks.  x: [B,S,d] final hidden states; head_table: [V,d]; labels:
    [B,S]."""
    b, s, _ = x.shape
    sc = min(s_chunk, s)
    while s % sc:
        sc //= 2
    total = x.new_zeros((), dtype=torch.float32)
    for s0 in range(0, s, sc):
        logits = unembed({"table": head_table}, x[:, s0:s0 + sc])
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, s0:s0 + sc].long()[..., None])[..., 0]
        total = total + (lse - gold).sum()
    return total / (b * s)
