"""Plain PyTorch version of RMSNorm."""
import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x: [..., d]; scale: [d] → x·rsqrt(mean(x²)+eps)·scale in x's dtype,
    statistics in fp32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
