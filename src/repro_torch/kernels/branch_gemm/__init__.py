from .ops import branch_gemm

__all__ = ["branch_gemm"]
