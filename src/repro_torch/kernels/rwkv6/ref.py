"""Plain PyTorch version of the WKV6 recurrence (the JAX package's
``kernels/rwkv6/ref.py``): the naive sequential loop over time."""
import torch


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """r, k, v, w: [B,H,T,K] fp32; u: [H,K]; s0: [B,H,K,K].
    Returns (out [B,H,T,K], s_final)."""
    s = s0
    outs = []
    for t in range(r.shape[2]):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]             # [B,H,K,K]
        outs.append(torch.einsum("bhk,bhkj->bhj", rt,
                                 u[None, :, :, None] * kv + s))
        s = wt[..., :, None] * s + kv
    if not outs:
        return torch.zeros_like(r), s
    return torch.stack(outs, dim=2), s
