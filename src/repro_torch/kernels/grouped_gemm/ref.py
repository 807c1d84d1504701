"""Plain PyTorch version of the grouped ragged-M GEMM."""
import torch


def grouped_gemm_ref(x: torch.Tensor, w: torch.Tensor,
                     group_sizes: tuple[int, ...]) -> torch.Tensor:
    """x: [sum_M, K] rows concatenated per group; w: [N, K, F];
    ``group_sizes``: N ints summing to sum_M → [sum_M, F] with fp32
    accumulation.  Zero-row groups contribute an empty segment."""
    outs, off = [], 0
    for i, m in enumerate(group_sizes):
        outs.append(torch.einsum("mk,kf->mf", x[off:off + m].float(),
                                 w[i].float()))
        off += m
    if not outs:
        return torch.zeros((0, w.shape[-1]), dtype=x.dtype, device=x.device)
    return torch.cat(outs, dim=0).to(x.dtype)
