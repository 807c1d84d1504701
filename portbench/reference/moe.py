"""Plain float32 forward of DeepSeek-V3 as one chip of its expert-parallel
deployment (the configuration's ``deployment``): embedding, per layer
RMSNorm → MLA → residual → RMSNorm → the dense SwiGLU (the leading
``moe.dense_prefix`` layers) or the MoE layer → residual, then the final
norm.  Weights are read in the port's parameter layout and widened layer
by layer.  Written from the published description, importing nothing of
the program.

MLA in its plain form: the query through its low-rank pair (``wq_a``,
RMSNorm, ``wq_b``), the compressed KV (``wkv_a``: the latent, RMSNorm'd,
and one rope key shared by every head); each head's key is its up-projected
nope part (``wk_b``) beside the shared rope key, its value the
up-projected latent (``wv_b``); RoPE with YaRN on the rope parts (the
frequencies ramped between ``beta_fast`` and ``beta_slow`` rotations of
the original context and divided by the factor past it; cos and sin times
mscale(factor, mscale) / mscale(factor, mscale_all_dim)), the two halves
of the rope dims rotated together; the softmax scale qk_head^-0.5 times
mscale(factor, mscale_all_dim)²; causal.

The MoE layer: router logits over every expert (float32 weights), sigmoid
scores, selection on scores + the balancing bias limited to each token's
``topk_group`` best of ``n_group`` groups (a group scores the sum of its
two best biased scores), top-k of what is left; combine weights the
unbiased scores of the chosen experts, normalised, times
``routed_scaling_factor``.  Only the held experts (``expert_rank`` ·
``held_experts`` onwards) are computed, one at a time over the tokens
routed to them; the absent experts add nothing; the shared expert is
added for every token.  ``quant="fp8"`` (the control) rounds every
product's operands to float8 first, the router's included."""
from __future__ import annotations

import torch

from portbench.reference.common import (exact_fp32, f32, layer, linear,
                                       mm, rmsnorm, swiglu)


def _ln(x: float) -> float:
    return torch.tensor(float(x), dtype=torch.float64).log().item()


def _mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * _ln(factor) + 1.0 if factor > 1 else 1.0


def rope(x: torch.Tensor, theta: float, y: dict | None) -> torch.Tensor:
    """x [B, S, H, D] at positions 0..S-1: each (i, i + D/2) pair rotated
    by position · freq_i, YaRN's frequencies and scale with ``y``."""
    b, s, _, dim = x.shape
    half = dim // 2
    freq = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=x.device) / dim)
    attn = 1.0
    if y is not None:
        def corr(rotations: float) -> float:
            return (dim * _ln(y["original_max_position_embeddings"]
                              / (rotations * 2 * torch.pi))
                    / (2 * _ln(theta)))
        low = max(int(corr(y["beta_fast"]) // 1), 0)               # floor
        high = min(-int(-corr(y["beta_slow"]) // 1), dim - 1)      # ceil
        if low == high:
            high += 0.001
        ramp = ((torch.arange(half, dtype=torch.float32, device=x.device)
                 - low) / (high - low)).clamp(0, 1)
        freq = freq / y["factor"] * ramp + freq * (1 - ramp)
        attn = (_mscale(y["factor"], y["mscale"])
                / _mscale(y["factor"], y["mscale_all_dim"]))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freq                                                  # [S, D/2]
    cos = (torch.cos(ang) * attn)[None, :, None, :]
    sin = (torch.sin(ang) * attn)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def mla(p: dict, x: torch.Tensor, cfg: dict,
        quant: str | None) -> torch.Tensor:
    m, nh, eps = cfg["mla"], cfg["n_heads"], cfg["norm_eps"]
    nope, rd = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    rank, vd = m["kv_lora_rank"], m["v_head_dim"]
    y = m.get("rope_scaling")
    b, s, _ = x.shape
    cq = rmsnorm(linear(x, p["wq_a"], quant), p["q_norm"]["scale"], eps)
    q = linear(cq, p["wq_b"], quant).reshape(b, s, nh, nope + rd)
    kv = linear(x, p["wkv_a"], quant)
    c_kv = rmsnorm(kv[..., :rank], p["kv_norm"]["scale"], eps)
    k_pe = rope(kv[..., rank:].reshape(b, s, 1, rd), cfg["rope_theta"], y)
    q_pe = rope(q[..., nope:], cfg["rope_theta"], y)
    k_nope = linear(c_kv, p["wk_b"], quant).reshape(b, s, nh, nope)
    v = linear(c_kv, p["wv_b"], quant).reshape(b, s, nh, vd)
    qh = torch.cat([q[..., :nope], q_pe], dim=-1).permute(0, 2, 1, 3)
    kh = torch.cat([k_nope, k_pe.expand(b, s, nh, rd)],
                   dim=-1).permute(0, 2, 1, 3)
    scale = (nope + rd) ** -0.5
    if y is not None and y.get("mscale_all_dim"):
        scale *= _mscale(y["factor"], y["mscale_all_dim"]) ** 2
    scores = mm(qh, kh.transpose(-1, -2), quant) * scale       # [B,H,S,S]
    pos = torch.arange(s, device=x.device)
    scores = scores.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    ctx = mm(torch.softmax(scores, dim=-1), v.permute(0, 2, 1, 3), quant)
    return linear(ctx.permute(0, 2, 1, 3).reshape(b, s, nh * vd), p["wo"],
                  quant)


def route(logits: torch.Tensor, bias: torch.Tensor, e: dict):
    """DeepSeek-V3's noaux_tc over ``logits [N, E]`` → (weights [N, k],
    experts [N, k])."""
    n, ne = logits.shape
    scores = torch.sigmoid(logits)
    biased = scores + bias[None, :]
    groups = biased.reshape(n, e["n_group"], ne // e["n_group"])
    group_score = groups.topk(2, dim=-1).values.sum(-1)          # [N, G]
    best = group_score.topk(e["topk_group"], dim=-1).indices
    keep = torch.zeros_like(group_score, dtype=torch.bool)
    keep[torch.arange(n, device=logits.device)[:, None], best] = True
    biased = groups.masked_fill(~keep[..., None], float("-inf")).reshape(n,
                                                                        ne)
    experts = biased.topk(e["top_k"], dim=-1).indices
    w = scores.gather(1, experts)
    return w / w.sum(-1, keepdim=True) * e["routed_scaling_factor"], experts


def moe(p: dict, x: torch.Tensor, cfg: dict,
        quant: str | None) -> torch.Tensor:
    e = cfg["moe"]
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    logits = mm(xf, f32(p["router"]["w"]), quant)
    w, experts = route(logits, f32(p["router"]["bias"]), e)
    first = e["expert_rank"] * e["held_experts"]
    y = torch.zeros_like(xf)
    for j in range(e["held_experts"]):
        tok, slot = torch.nonzero(experts == first + j, as_tuple=True)
        if tok.numel():
            ex = {k: {"w": f32(p["experts"][k][j])}
                  for k in ("gate", "up", "down")}
            y[tok] += w[tok, slot][:, None] * swiglu(xf[tok], ex, quant)
    if e["n_shared"]:
        y = y + swiglu(xf, p["shared"], quant)
    return y.reshape(b, s, d)


def hidden(cfg: dict, w: dict, ids: torch.Tensor,
           quant: str | None = None) -> torch.Tensor:
    """ids [B,S] → final-normed hidden states [B,S,d] in float32."""
    eps = cfg["norm_eps"]
    dense = min(cfg["moe"]["dense_prefix"], max(cfg["n_layers"] - 1, 0))
    stacks = ([(w["stacks"][0], dense, False)] if dense else []) + [
        (w["stacks"][-1], cfg["n_layers"] - dense, True)]
    with exact_fp32(), torch.no_grad():
        x = f32(w["embed"]["table"][ids])
        for stack, n, is_moe in stacks:
            for i in range(n):
                p = layer(stack, i)
                x = x + mla(p["attn"], rmsnorm(x, p["norm1"]["scale"], eps),
                            cfg, quant)
                h = rmsnorm(x, p["norm2"]["scale"], eps)
                x = x + (moe(p["ffn"], h, cfg, quant) if is_moe
                         else swiglu(h, p["ffn"], quant))
        return rmsnorm(x, w["final_norm"]["scale"], eps)
