"""State-space blocks: RWKV-6 ("Finch") and the Mamba-style selective SSM
head that Hymba runs in parallel with attention.

The port of the JAX package's ``models/ssm.py``.  Each block has a
sequence form that processes T tokens from a carried state and returns the
new state; a decode step is the sequence form at T = 1.

RWKV-6, per head of size K with the state S [K, K] in fp32:

    out_t = r_t · (diag(u)·k_tᵀv_t + S_{t-1})
    S_t   = diag(w_t)·S_{t-1} + k_tᵀv_t          (w_t data-dependent decay)

With ``use_kernels`` it runs in the port's ``rwkv6`` kernel at every T (the
JAX package's decode step runs the plain recurrence; the kernel computes the
same function, so the card's decode path has no plain version on it);
otherwise in :func:`wkv_scan_ref`, a Python loop over time.

Mamba, with the state h [B, di, N] in fp32 and the conv state [B, K-1, di]
in the model dtype:

    h_t = exp(Δ_t·A)·h_{t-1} + (Δ_t·x_t) ⊗ B_t ;  y_t = C_t·h_t + D·x_t

The JAX package has no scan kernel.  The port has one on the op graph's
path: the exporter's scan stage goes through ``kernels.mamba_scan`` (the
CUDA kernel on the card, its plain version, built on :func:`mamba_scan`, on
the CPU).  Here :func:`mamba_scan_ref` is the per-token loop of the JAX
package; :func:`mamba_scan` computes the same recurrence with the
discretised terms of every step made ahead of the loop and one in-place
update of h a step, then contracts C after the loop.  Serving runs
:func:`mamba_scan`; when a grad is wanted (the training loss)
:func:`mamba_seq` runs :func:`mamba_scan_ref`, whose steps are out of place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..utils import shard
from ..utils.sharding_ctx import on_local_shards
from .layers import check_device, init_linear, linear

RWKV_LORA = 32  # data-dependent decay LoRA rank (Finch §3)


def _head_size(cfg: ModelConfig) -> int:
    return cfg.ssm.head_dim if cfg.ssm else 64


def init_rwkv_time_mix(generator: torch.Generator, cfg: ModelConfig, *,
                       device: torch.device | str,
                       lead: tuple[int, ...] = ()) -> dict:
    d = cfg.d_model
    hs = _head_size(cfg)
    n_heads = d // hs
    dt = cfg.dtype
    device = check_device(device)
    kw = {"device": device, "lead": lead}
    return {
        # token-shift mixes of (r, k, v, g, w)
        "mu": torch.rand(lead + (5, d), generator=generator,
                         dtype=torch.float32, device=device).to(dt),
        "wr": init_linear(generator, d, d, False, dt, **kw),
        "wk": init_linear(generator, d, d, False, dt, **kw),
        "wv": init_linear(generator, d, d, False, dt, **kw),
        "wg": init_linear(generator, d, d, False, dt, **kw),
        "wo": init_linear(generator, d, d, False, dt, **kw),
        # decay: w_t = exp(-exp(base + lora(x)))
        "w_base": torch.full(lead + (d,), -6.0, dtype=torch.float32,
                             device=device),
        "w_lora_a": init_linear(generator, d, RWKV_LORA, False, dt, **kw),
        "w_lora_b": init_linear(generator, RWKV_LORA, d, False, dt, **kw),
        "u": torch.randn(lead + (n_heads, hs), generator=generator,
                         dtype=torch.float32, device=device) * 0.1,
        "ln_x": {"scale": torch.ones(lead + (d,), dtype=dt, device=device),
                 "bias": torch.zeros(lead + (d,), dtype=dt, device=device)},
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """x: [B,T,d] shifted right by one; the first slot is x_prev [B,d]."""
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _rwkv_proj(p: dict, x: torch.Tensor, x_prev: torch.Tensor):
    """The 5 parallel token-shift projections (r, k, v, g, w)."""
    xs = _token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    mix = [x + (xs - x) * mu[i] for i in range(5)]
    r = linear(p["wr"], mix[0])
    k = linear(p["wk"], mix[1])
    v = linear(p["wv"], mix[2])
    g = torch.nn.functional.silu(linear(p["wg"], mix[3]))
    w_log = p["w_base"] + linear(
        p["w_lora_b"], torch.tanh(linear(p["w_lora_a"], mix[4]))).float()
    w = torch.exp(-torch.exp(w_log))                 # decay in (0, 1)
    return r, k, v, g, w


def wkv_scan_ref(rh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                 wh: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """The plain WKV recurrence on head-split fp32 tensors [B,T,H,K] →
    (s_final [B,H,K,K], y [B,T,H,K]).  Shared by :func:`rwkv_time_mix_seq`
    and the exporter's scan payload."""
    s = s0
    outs = []
    for t in range(rh.shape[1]):
        rt, kt, vt, wt = rh[:, t], kh[:, t], vh[:, t], wh[:, t]
        kv = kt[..., :, None] * vt[..., None, :]           # [B,H,K,K]
        outs.append(torch.einsum("bhk,bhkj->bhj", rt,
                                 u[None, :, :, None] * kv + s))
        s = wt[..., :, None] * s + kv
    return s, torch.stack(outs, dim=1)


def _wkv_scan(use_kernels: bool, *operands: torch.Tensor):
    """(s_final, y) from the ``rwkv6`` kernel or :func:`wkv_scan_ref`."""
    if use_kernels:
        from ..kernels.rwkv6 import rwkv6_model
        y, s_final = rwkv6_model(*operands)
        return s_final, y
    return wkv_scan_ref(*operands)


def rwkv_time_mix_seq(p: dict, x: torch.Tensor, state, cfg: ModelConfig,
                      use_kernels: bool = False):
    """x: [B,T,d]; state: (x_prev [B,d], S [B,H,K,K] fp32) → (y, state')."""
    b, t, d = x.shape
    hs = _head_size(cfg)
    h = d // hs
    x_prev, s0 = state
    r, k, v, g, w = _rwkv_proj(p, x, x_prev)
    rh = r.reshape(b, t, h, hs).float()
    kh = k.reshape(b, t, h, hs).float()
    vh = v.reshape(b, t, h, hs).float()
    wh = w.reshape(b, t, h, hs)
    operands = (rh, kh, vh, wh, p["u"], s0)
    if any(isinstance(t, DTensor) for t in operands):
        # independent per (row, head): each rank scans its own rows and
        # heads, the sequence and the head size whole
        s_final, y = on_local_shards(
            lambda *t: _wkv_scan(use_kernels, *t),
            "bthk,bthk,bthj,bthk,hk,bhkj->bhkj,bthj", *operands, split="bh")
    else:
        s_final, y = _wkv_scan(use_kernels, *operands)

    y = y.reshape(b, t, d).to(x.dtype)
    # group-norm over each head (ln_x), then the gate and the output proj
    yf = y.float().reshape(b, t, h, hs)
    mu_ = yf.mean(-1, keepdim=True)
    var = yf.var(-1, unbiased=False, keepdim=True)
    yf = (yf - mu_) * torch.rsqrt(var + 1e-5)
    y = (yf.reshape(b, t, d) * p["ln_x"]["scale"].float()
         + p["ln_x"]["bias"].float()).to(x.dtype)
    y = linear(p["wo"], y * g)
    return shard(y, "batch", "seq", "embed"), (x[:, -1], s_final)


def rwkv_time_mix_step(p: dict, x: torch.Tensor, state, cfg: ModelConfig,
                       use_kernels: bool = False):
    """Decode: x [B,1,d]."""
    return rwkv_time_mix_seq(p, x, state, cfg, use_kernels)


def init_rwkv_channel_mix(generator: torch.Generator, cfg: ModelConfig, *,
                          device: torch.device | str,
                          lead: tuple[int, ...] = ()) -> dict:
    d, dff = cfg.d_model, cfg.d_ff
    dt = cfg.dtype
    device = check_device(device)
    kw = {"device": device, "lead": lead}
    return {
        "mu": torch.rand(lead + (2, d), generator=generator,
                         dtype=torch.float32, device=device).to(dt),
        "wk": init_linear(generator, d, dff, False, dt, **kw),
        "wv": init_linear(generator, dff, d, False, dt, **kw),
    }


def rwkv_channel_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
                     cfg: ModelConfig):
    xs = _token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    xk = x + (xs - x) * mu[0]
    k = torch.square(torch.relu(linear(p["wk"], xk)))
    return linear(p["wv"], k), x[:, -1]


def rwkv_state_init(cfg: ModelConfig, batch: int, *,
                    device: torch.device | str) -> dict:
    d = cfg.d_model
    hs = _head_size(cfg)
    h = d // hs
    return {
        "tm_x": torch.zeros((batch, d), dtype=cfg.dtype, device=device),
        "tm_s": torch.zeros((batch, h, hs, hs), dtype=torch.float32,
                            device=device),
        "cm_x": torch.zeros((batch, d), dtype=cfg.dtype, device=device),
    }


# =============================== Mamba head ==================================

def init_mamba(generator: torch.Generator, cfg: ModelConfig, *,
               device: torch.device | str,
               lead: tuple[int, ...] = ()) -> dict:
    """Selective SSM head for Hymba (runs in parallel with attention)."""
    d = cfg.d_model
    s = cfg.ssm
    di = s.expand * d
    dt = cfg.dtype
    device = check_device(device)
    kw = {"device": device, "lead": lead}
    a = torch.arange(1, s.state_dim + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": init_linear(generator, d, 2 * di, False, dt, **kw),  # x, z
        "conv_w": (torch.randn(lead + (s.conv_dim, di), generator=generator,
                               dtype=torch.float32, device=device)
                   * 0.2).to(dt),
        "x_proj": init_linear(generator, di, s.state_dim * 2 + 1, False, dt,
                              **kw),                                 # B, C, dt
        "a_log": torch.log(a).expand(lead + (di, s.state_dim)).clone(),
        "d_skip": torch.ones(lead + (di,), dtype=torch.float32,
                             device=device),
        "out_proj": init_linear(generator, di, d, False, dt, **kw),
    }


def _mamba_conv_seq(w: torch.Tensor, x: torch.Tensor,
                    conv_state: torch.Tensor):
    """Causal depthwise conv over time, then silu.  x: [B,T,di]; w: [K,di];
    conv_state: [B,K-1,di] → (y [B,T,di], conv_state')."""
    k = w.shape[0]
    t = x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)       # [B,T+K-1,di]
    out = xp[:, :t] * w[0].to(x.dtype)
    for i in range(1, k):
        out = out + xp[:, i:i + t] * w[i].to(x.dtype)
    return F.silu(out), xp[:, t:]


def mamba_scan_ref(delta: torch.Tensor, xi: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """The discretised selective scan on fp32 tensors, one token a step as
    the JAX package's ``mamba_scan_ref``.  delta [B,T,1], xi [B,T,di], B/C
    [B,T,N], a [di,N], h0 [B,di,N] → (h_final, y [B,T,di])."""
    h = h0
    ys = []
    for t in range(xi.shape[1]):
        da_t = torch.exp(delta[:, t, :, None] * a[None])    # [B,di,N]
        h = da_t * h + (delta[:, t] * xi[:, t])[..., None] * bmat[:, t, None]
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t]))
    return h, torch.stack(ys, dim=1)


def mamba_scan(delta: torch.Tensor, xi: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """:func:`mamba_scan_ref`'s recurrence with one launch a step: the
    decays ``exp(Δ_t·A)`` and inputs ``(Δ_t·x_t) ⊗ B_t`` of every step are
    made ahead of the loop (``[B,T,di,N]`` fp32 each), each step updates
    its slice of the state history in place, and C is contracted with the
    whole history after it."""
    decay = torch.exp(delta[..., None] * a)                  # [B,T,di,N]
    hist = (delta * xi)[..., None] * bmat[:, :, None, :]     # [B,T,di,N]
    hist[:, 0].addcmul_(decay[:, 0], h0)
    for t in range(1, xi.shape[1]):
        hist[:, t].addcmul_(decay[:, t], hist[:, t - 1])
    y = torch.einsum("btdn,btn->btd", hist, cmat)
    return hist[:, -1].clone(), y


def _mamba_scan(*operands: torch.Tensor):
    """:func:`mamba_scan`, which updates its state history in place; under
    a loss (autograd refuses that) the out-of-place
    :func:`mamba_scan_ref`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return mamba_scan_ref(*operands)
    return mamba_scan(*operands)


def mamba_seq(p: dict, x: torch.Tensor, state, cfg: ModelConfig):
    """x: [B,T,d]; state: (conv_state [B,K-1,di], h [B,di,N] fp32) →
    (out [B,T,d], state')."""
    s = cfg.ssm
    conv_state, h0 = state
    xz = linear(p["in_proj"], x)
    xi, z = torch.chunk(xz, 2, dim=-1)
    xi, conv_state = _mamba_conv_seq(p["conv_w"], xi, conv_state)
    bcd = linear(p["x_proj"], xi)
    bmat, cmat, dt_raw = torch.split(bcd, [s.state_dim, s.state_dim, 1],
                                     dim=-1)
    delta = F.softplus(dt_raw.float()) + 1e-4                 # [B,T,1]
    a = -torch.exp(p["a_log"])                                # [di,N]
    xf = xi.float()
    operands = (delta, xf, bmat.float(), cmat.float(), a, h0)
    if any(isinstance(t, DTensor) for t in operands):
        # independent per (row, channel): each rank scans its own rows and
        # di channels, the sequence and the state whole
        h_final, ys = on_local_shards(_mamba_scan, "bto,btc,btn,btn,cn,bcn"
                                      "->bcn,btc", *operands, split="bc")
    else:
        h_final, ys = _mamba_scan(*operands)
    y = ys + xf * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    return (shard(linear(p["out_proj"], y), "batch", "seq", "embed"),
            (conv_state, h_final))


def mamba_state_init(cfg: ModelConfig, batch: int, *,
                     device: torch.device | str):
    """(conv_state [B,K-1,di] in the model dtype, h [B,di,N] fp32)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return (torch.zeros((batch, s.conv_dim - 1, di), dtype=cfg.dtype,
                        device=device),
            torch.zeros((batch, di, s.state_dim), dtype=torch.float32,
                        device=device))
