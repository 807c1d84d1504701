"""Plain PyTorch version of the grouped expert SwiGLU MLP (the JAX
package's ``kernels/moe_gemm/ref.py``): products accumulate in fp32, h stays
in fp32 until it is rounded to the buffer's dtype for the down GEMM."""
import torch

from ...models.layers import matmul_f32


def moe_mlp_ref(buf: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                down: torch.Tensor, counts: torch.Tensor | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """buf: [E,C,d]; gate/up: [E,d,f]; down: [E,f,d] → [E,C,d], into
    ``out`` where given.  With ``counts`` [E] only the first ``counts[e]``
    rows of expert e are written; the others keep ``out``'s values (or
    whatever ``torch.empty`` held)."""
    h = torch.nn.functional.silu(matmul_f32(buf, gate)) * matmul_f32(buf, up)
    y = matmul_f32(h.to(buf.dtype), down).to(buf.dtype)
    if counts is None:
        return y if out is None else out.copy_(y)
    out = torch.empty_like(y) if out is None else out
    rows = torch.arange(buf.shape[1], device=buf.device)
    keep = (rows[None, :] < counts[:, None].to(rows.device))[..., None]
    return out.copy_(torch.where(keep, y, out))
