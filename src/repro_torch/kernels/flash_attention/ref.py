"""Plain PyTorch version of causal/windowed GQA prefill attention: exact
(non-streaming) masked softmax in fp32, as the JAX reference.

The layout is the model's, ``q [B,S,H,D]`` and ``k, v [B,T,KVH,D]``, which
is what the kernel reads; the JAX reference takes ``[B,H,S,D]``.
"""
import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,S,H,D]; k, v: [B,T,KVH,D] → [B,S,H,D].  Query head h reads KV
    head h // (H/KVH); positions count from 0 on both sides; ``window > 0``
    keeps keys with k_pos > q_pos - window."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, s, kvh, g, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * d ** -0.5
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
