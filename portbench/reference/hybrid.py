"""Plain float32 forward of a Hymba-style hybrid decoder: per layer one
RMSNorm feeds attention (windowed, but in ``global_layers``) and a Mamba
head in parallel, their outputs averaged, then the residual, RMSNorm,
SwiGLU and the residual; then the final norm.  No rotary embedding and no
meta tokens: the op graph the benchmark drives has neither (ROADMAP C5,
C13).

The Mamba head: in_proj to [x ‖ z] (each expand·d wide), a causal
depthwise convolution of x from a zero state and SiLU, one projection to
B, C (state_dim each) and a step size Δ (softplus + 1e-4), then the
selective scan h_t = exp(Δ_t·A)·h_{t-1} + Δ_t·x_t·B_t, y_t = C_t·h_t,
taken one position at a time, with A = -exp(a_log); y + D·x, gated by
SiLU(z), then out_proj."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import (attention, exact_fp32, f32,
                                       layer, linear, rmsnorm, swiglu)


def mamba(p: dict, x: torch.Tensor, n_state: int,
          quant: str | None) -> torch.Tensor:
    b, s, _ = x.shape
    xz = linear(x, p["in_proj"], quant)
    di = xz.shape[-1] // 2
    xi, z = xz[..., :di], xz[..., di:]
    w = f32(p["conv_w"])                                       # [K, di]
    kw = w.shape[0]
    xp = torch.cat([xi.new_zeros(b, kw - 1, di), xi], dim=1)
    conv = sum(xp[:, j:j + s] * w[j] for j in range(kw))
    xi = F.silu(conv)
    bcd = linear(xi, p["x_proj"], quant)
    bmat, cmat, dt = bcd[..., :n_state], bcd[..., n_state:2 * n_state], \
        bcd[..., 2 * n_state:]
    delta = F.softplus(dt) + 1e-4                              # [B,S,1]
    a = -torch.exp(f32(p["a_log"]))                            # [di,N]
    h = xi.new_zeros(b, di, n_state)
    ys = []
    for t in range(s):
        h = torch.exp(delta[:, t, :, None] * a) * h \
            + (delta[:, t] * xi[:, t])[..., None] * bmat[:, t, None, :]
        ys.append((h * cmat[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) + xi * f32(p["d_skip"])
    return linear(y * F.silu(z), p["out_proj"], quant)


def hidden(cfg: dict, w: dict, ids: torch.Tensor,
           quant: str | None = None) -> torch.Tensor:
    """ids [B,S] → final-normed hidden states [B,S,d] in float32."""
    h, kvh, d = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    eps = cfg["norm_eps"]
    stack = w["stacks"][0]
    with exact_fp32(), torch.no_grad():
        x = f32(w["embed"]["table"][ids])
        b, s, _ = x.shape
        for i in range(cfg["n_layers"]):
            p = layer(stack, i)
            window = None if i in cfg["global_layers"] else cfg["window"]
            n1 = rmsnorm(x, p["norm1"]["scale"], eps)
            a = p["attn"]
            q = linear(n1, a["wq"], quant).reshape(b, s, h, d)
            k = linear(n1, a["wk"], quant).reshape(b, s, kvh, d)
            v = linear(n1, a["wv"], quant).reshape(b, s, kvh, d)
            att = linear(attention(q, k, v, window, quant), a["wo"], quant)
            m = mamba(p["mamba"], n1, cfg["ssm"]["state_dim"], quant)
            x = x + 0.5 * (att + m)
            x = x + swiglu(rmsnorm(x, p["norm2"]["scale"], eps), p["ffn"],
                           quant)
        return rmsnorm(x, w["final_norm"]["scale"], eps)
