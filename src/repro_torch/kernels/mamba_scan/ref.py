"""Plain PyTorch version of the op graph's Mamba scan stage (the CPU's path,
and the yardstick the kernel is held against on the card): the
discretisation, :func:`repro_torch.models.ssm.mamba_scan` from the zero
state, the skip and the silu(z) gate, as the scan payload computed them."""
import torch
import torch.nn.functional as F


def mamba_scan_stage_ref(packed: torch.Tensor, a_log: torch.Tensor,
                   d_skip: torch.Tensor) -> torch.Tensor:
    """packed [B,T,2·di+2·N+1] (x ‖ z ‖ B ‖ C ‖ Δ_raw); a_log [di,N];
    d_skip [di] → out [B,T,di] in packed's dtype."""
    from ...models.ssm import mamba_scan
    di, n = a_log.shape
    xi = packed[..., :di].float()
    z = packed[..., di:2 * di]
    bmat, cmat, dt_raw = torch.split(packed[..., 2 * di:].float(),
                                     [n, n, 1], dim=-1)
    delta = F.softplus(dt_raw) + 1e-4
    h0 = torch.zeros((xi.shape[0], di, n), dtype=torch.float32,
                     device=xi.device)
    _, ys = mamba_scan(delta, xi, bmat, cmat, -torch.exp(a_log), h0)
    y = ys + xi * d_skip
    return y.to(packed.dtype) * F.silu(z)
