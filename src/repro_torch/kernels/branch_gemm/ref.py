"""Plain PyTorch version of the fused branch GEMM."""
import torch


def branch_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [N,M,K]; w: [N,K,F] → [N,M,F] with fp32 accumulation."""
    return torch.einsum("nmk,nkf->nmf", x.float(), w.float()).to(x.dtype)
