"""Plain PyTorch version of the grouped expert SwiGLU MLP (the JAX
package's ``kernels/moe_gemm/ref.py``): products accumulate in fp32, h stays
in fp32 until it is rounded to the buffer's dtype for the down GEMM."""
import torch


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, fp32 accumulation and an fp32 result, without an
    fp32 copy of either operand on the card (an expert stack of Kimi-K2 is
    5.6 GB in bf16, 11.3 GB in fp32)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def moe_mlp_ref(buf: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                down: torch.Tensor) -> torch.Tensor:
    """buf: [E,C,d]; gate/up: [E,d,f]; down: [E,f,d] → [E,C,d]."""
    h = torch.nn.functional.silu(bmm_f32(buf, gate)) * bmm_f32(buf, up)
    return bmm_f32(h.to(buf.dtype), down).to(buf.dtype)
