"""Plain PyTorch version of the grouped expert SwiGLU MLP (the JAX
package's ``kernels/moe_gemm/ref.py``): products accumulate in fp32, h stays
in fp32 until it is rounded to the buffer's dtype for the down GEMM."""
import torch

from ...models.layers import matmul_f32


def moe_mlp_ref(buf: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                down: torch.Tensor) -> torch.Tensor:
    """buf: [E,C,d]; gate/up: [E,d,f]; down: [E,f,d] → [E,C,d]."""
    h = torch.nn.functional.silu(matmul_f32(buf, gate)) * matmul_f32(buf, up)
    return matmul_f32(h.to(buf.dtype), down).to(buf.dtype)
