"""Plain PyTorch version of single-token decode attention.

:func:`attend_one` is the routine both decode wrappers' plain versions
share (the paged one gathers its pages first), as their kernels share one
device routine: operands in their own dtype, fp32 logits and accumulation,
probabilities rounded to the value dtype before the weighted sum — the
numerics of the model's plain attention (``models/attention._sdpa``), so a
paged decode equals a dense one here too.
"""
import torch

NEG_INF = -1e30


def attend_one(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid: torch.Tensor, scale: float) -> torch.Tensor:
    """q: [B,H,Dk]; k: [B,T,KVH,Dk]; v: [B,T,KVH,Dv]; valid: [B,T] bool →
    [B,H,Dv] in q's dtype."""
    b, h, dk = q.shape
    kvh, dv = k.shape[2], v.shape[-1]
    qg = q.reshape(b, kvh, h // kvh, dk)
    logits = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) * scale
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, h, dv).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """q: [B,H,D]; k, v: the cache [B,T,KVH,D]; valid: [B,T] bool → [B,H,D].

    The layout is the cache's (the kernel reads it in place); the JAX
    reference takes ``[B,KVH,T,D]``."""
    return attend_one(q, k, v, valid, q.shape[-1] ** -0.5)
