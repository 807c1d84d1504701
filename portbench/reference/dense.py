"""Plain float32 forward of a dense decoder (GLM-4): embedding, per layer
RMSNorm → grouped-query attention with QKV bias → residual → RMSNorm →
SwiGLU → residual, then the final norm.  No rotary embedding: the op graph
the benchmark drives applies none (ROADMAP C5).  Weights are read in the
port's parameter layout and widened layer by layer."""
from __future__ import annotations

import torch

from portbench.reference.common import (attention, exact_fp32, f32,
                                       layer, linear, rmsnorm, swiglu)


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
            n1 = rmsnorm(x, p["norm1"]["scale"], eps)
            a = p["attn"]
            q = linear(n1, a["wq"], quant).reshape(b, s, h, d)
            k = linear(n1, a["wk"], quant).reshape(b, s, kvh, d)
            v = linear(n1, a["wv"], quant).reshape(b, s, kvh, d)
            x = x + linear(attention(q, k, v, None, quant), a["wo"], quant)
            x = x + swiglu(rmsnorm(x, p["norm2"]["scale"], eps), p["ffn"],
                           quant)
        return rmsnorm(x, w["final_norm"]["scale"], eps)
