"""Feed-forward: the dense SwiGLU / GELU MLP and Mixture-of-Experts.

MoE follows the JAX package's ``models/ffn.py``: static-capacity dispatch
with top-k routing (sigmoid scores plus a selection-only bias for the
aux-loss-free configs, softmax otherwise), an always-on shared expert, and
the expert MLP over ``[E, C, d]`` capacity buffers.  Two dispatches compute
the same function: the one-hot form (:func:`moe_ffn_dense`, small expert
counts, the oracle) and the sort form (:func:`moe_ffn_sort`, more than 32
experts).  The sort form makes no host round trip — no ``nonzero``, no
boolean indexing, no ``.item()``, no tensor-count ``repeat_interleave`` —
so a decode step that runs it can be recorded into a CUDA graph.

Expert numerics (ROADMAP C4): with ``use_kernels`` the expert MLP is the
``moe_gemm`` kernel, which like the JAX package's ``moe_mlp_ref`` keeps h in
fp32 until the down GEMM; the plain route copies the JAX package's inline
path, which rounds ``silu(x @ gate)`` and ``x @ up`` to the activation dtype
first.  Expert parallelism: under sharding rules the ``[E, C, d]``
capacity buffers are laid out over the ``expert`` logical axis (``model``,
or data×model with ``expert_2d``), as the reference's, so each rank runs
its own experts' MLPs.
"""
from __future__ import annotations

import itertools

import torch

from ..configs.base import ModelConfig
from ..utils import shard
from ..utils.sharding_ctx import whole
from .layers import check_device, gelu, init_linear, linear, matmul_f32


# -- dense MLP ----------------------------------------------------------------

def init_mlp(generator: torch.Generator, d: int, d_ff: int, act: str,
             dtype: torch.dtype = torch.bfloat16, *,
             device: torch.device | str, lead: tuple[int, ...] = ()) -> dict:
    kw = {"device": device, "lead": lead}
    if act == "swiglu":
        return {
            "gate": init_linear(generator, d, d_ff, False, dtype, **kw),
            "up": init_linear(generator, d, d_ff, False, dtype, **kw),
            "down": init_linear(generator, d_ff, d, False, dtype, **kw),
        }
    return {
        "up": init_linear(generator, d, d_ff, False, dtype, **kw),
        "down": init_linear(generator, d_ff, d, False, dtype, **kw),
    }


def mlp(p: dict, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    if "gate" in p:
        h = torch.nn.functional.silu(linear(p["gate"], x)) * linear(p["up"], x)
    else:
        h = gelu(linear(p["up"], x))
    if h.dim() == 3:
        h = shard(h, "batch", "seq", "mlp")
    else:  # flattened tokens (the MoE shared expert)
        h = shard(h, "batch", "mlp")
    return linear(p["down"], h)


# -- MoE ----------------------------------------------------------------------

def _expert_stack(generator: torch.Generator, shape: tuple[int, ...],
                  scale: float, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """Normal(0, scale) weights of ``shape`` = lead + (E, d_in, d_out),
    drawn one expert matrix at a time, so the fp32 draw never holds more
    than one matrix (a whole fp32 stack of Kimi-K2 is 22.5 GB).  On the
    meta device (the dry-run's shapes) nothing is drawn."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    for idx in itertools.product(*(range(n) for n in shape[:-2])):
        out[idx] = (torch.randn(shape[-2:], generator=generator,
                                dtype=torch.float32, device=device)
                    * scale).to(dtype)
    return out


def init_moe(generator: torch.Generator, cfg: ModelConfig, *,
             device: torch.device | str, lead: tuple[int, ...] = ()) -> dict:
    """Router (fp32 weights and a zero balancing bias), stacked expert
    weights ``[*lead, E, ...]`` in the config's dtype, the shared expert."""
    e = cfg.moe
    d, dtype = cfg.d_model, cfg.dtype
    device = check_device(device)
    p = {
        "router": {
            "w": torch.randn(lead + (d, e.n_experts), generator=generator,
                             dtype=torch.float32, device=device) * d ** -0.5,
            "bias": torch.zeros(lead + (e.n_experts,), dtype=torch.float32,
                                device=device),
        },
        "experts": {
            "gate": _expert_stack(generator,
                                  lead + (e.n_experts, d, e.d_expert),
                                  d ** -0.5, dtype, device),
            "up": _expert_stack(generator,
                                lead + (e.n_experts, d, e.d_expert),
                                d ** -0.5, dtype, device),
            "down": _expert_stack(generator,
                                  lead + (e.n_experts, e.d_expert, d),
                                  e.d_expert ** -0.5, dtype, device),
        },
    }
    if e.n_shared:
        p["shared"] = init_mlp(generator, d, e.d_expert * e.n_shared,
                               "swiglu", dtype, device=device, lead=lead)
    return p


def route(p_router: dict, x: torch.Tensor, e,
          generator: torch.Generator | None = None):
    """Top-k routing of ``x [N, d]`` → (weights [N,k], experts [N,k], aux).

    Aux-loss-free configs select on sigmoid scores plus the per-expert bias
    and combine with the unbiased scores.  With ``generator`` and a nonzero
    ``router_noise``, Gaussian noise is added to the selection scores."""
    logits = torch.matmul(x.float(), p_router["w"])
    scores = (torch.sigmoid(logits) if e.router_aux_free
              else torch.softmax(logits, dim=-1))
    select = scores + p_router["bias"][None, :] if e.router_aux_free \
        else scores
    if generator is not None and e.router_noise > 0:
        select = select + torch.randn(select.shape, generator=generator,
                                      device=select.device) * e.router_noise
    top_idx = torch.topk(select, e.top_k, dim=-1).indices           # [N,k]
    top_w = torch.gather(scores, -1, top_idx)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # whole on every rank: torch 2.11's DTensor splits an index_add's
    # source and index apart
    flat_idx = whole(top_idx.reshape(-1))
    counts = torch.zeros(e.n_experts, dtype=torch.float32,
                         device=x.device).index_add(
        0, flat_idx, torch.ones_like(flat_idx, dtype=torch.float32))
    load = counts / torch.clamp(counts.sum(), min=1.0)
    importance = scores.mean(0)
    aux = {"load": load,
           "aux_loss": e.n_experts * torch.sum(load * importance)}
    return top_w, top_idx, aux


def _capacity(n: int, e) -> int:
    return min(int(max(1, round(n * e.top_k / e.n_experts
                                * e.capacity_factor))), n)


def _expert_mlp(p_experts: dict, buf: torch.Tensor,
                use_kernels: bool) -> torch.Tensor:
    """buf [E,C,d] → [E,C,d], every expert in one grouped computation."""
    if use_kernels:
        from ..kernels.moe_gemm import moe_mlp
        return moe_mlp(buf, p_experts["gate"], p_experts["up"],
                       p_experts["down"])
    dt = buf.dtype
    h = torch.nn.functional.silu(matmul_f32(buf, p_experts["gate"]).to(dt))
    h = h * matmul_f32(buf, p_experts["up"]).to(dt)
    return matmul_f32(h, p_experts["down"]).to(dt)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_ffn_dense(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  generator: torch.Generator | None = None,
                  use_kernels: bool = False):
    """One-hot capacity-dense dispatch (GShard-style einsums): O(N·E·C)
    dispatch tensors, the small-E path and the oracle of the sort path."""
    e = cfg.moe
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    top_w, top_idx, aux = route(p["router"], xf, e, generator)

    cap = _capacity(n, e)
    onehot = _one_hot(top_idx, e.n_experts, torch.int32)            # [N,k,E]
    flatoh = onehot.reshape(n * e.top_k, e.n_experts)
    pos_in_e = (torch.cumsum(flatoh, dim=0) - flatoh).reshape(
        n, e.top_k, e.n_experts)
    pos = torch.sum(pos_in_e * onehot, dim=-1)                      # [N,k]
    keep = pos < cap
    w = top_w * keep

    disp = (onehot * keep[..., None]).to(xf.dtype)                  # [N,k,E]
    poh = _one_hot(pos, cap, xf.dtype)                              # [N,k,C]
    comb = torch.einsum("nke,nkc->nec", disp, poh)                  # [N,E,C]
    buf = torch.einsum("nec,nd->ecd", comb, xf)                     # [E,C,d]
    buf = shard(buf, "expert", None, None)
    out_buf = shard(_expert_mlp(p["experts"], buf, use_kernels),
                    "expert", None, None)
    comb_w = torch.einsum("nke,nkc,nk->nec", disp, poh, w.to(xf.dtype))
    y = torch.einsum("nec,ecd->nd", comb_w, out_buf)
    if e.n_shared:
        y = y + mlp(p["shared"], xf, "swiglu")
    return y.reshape(b, s, d), aux


def moe_ffn_sort(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 generator: torch.Generator | None = None,
                 use_kernels: bool = False):
    """Sort-based capacity dispatch (the production path, large E): the
    (token, k) pairs are stably sorted by expert, ranked within their
    expert, and added into an ``[E·C + 1, d]`` buffer whose last row takes
    the pairs past capacity; the combine is the transposed gather."""
    e = cfg.moe
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    top_w, top_idx, aux = route(p["router"], xf, e, generator)

    cap = _capacity(n, e)
    nk = n * e.top_k
    dev = x.device
    expert_flat = top_idx.reshape(nk)                               # [NK]
    tok_flat = torch.arange(nk, device=dev) // e.top_k              # [NK]
    w_flat = top_w.reshape(nk)

    order = torch.argsort(expert_flat, stable=True)                 # [NK]
    sorted_e = expert_flat[order]
    counts = torch.zeros(e.n_experts, dtype=torch.long,
                         device=dev).index_add(
        0, whole(expert_flat), torch.ones_like(whole(expert_flat)))
    starts = torch.cumsum(counts, dim=0) - counts                   # [E]
    pos_sorted = torch.arange(nk, device=dev) - starts[sorted_e]
    pos = torch.empty(nk, dtype=torch.long, device=dev).scatter(
        0, order, pos_sorted)                                       # [NK]

    keep = pos < cap
    slot = torch.where(keep, expert_flat * cap + pos,
                       torch.full_like(pos, e.n_experts * cap))
    gathered = xf[tok_flat] * keep[:, None].to(xf.dtype)            # [NK,d]
    buf = torch.zeros((e.n_experts * cap + 1, d), dtype=xf.dtype,
                      device=dev).index_add(0, slot, gathered)
    buf = buf[:e.n_experts * cap].reshape(e.n_experts, cap, d)
    buf = shard(buf, "expert", None, None)

    out_buf = shard(_expert_mlp(p["experts"], buf, use_kernels),
                    "expert", None, None)

    rows = out_buf.reshape(e.n_experts * cap, d)[
        torch.clamp(slot, max=e.n_experts * cap - 1)]
    rows = rows * (w_flat * keep)[:, None].to(xf.dtype)             # [NK,d]
    y = rows.reshape(n, e.top_k, d).sum(dim=1)
    if e.n_shared:
        y = y + mlp(p["shared"], xf, "swiglu")
    return y.reshape(b, s, d), aux


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig,
            generator: torch.Generator | None = None,
            use_kernels: bool = False):
    if cfg.moe.n_experts > 32:
        return moe_ffn_sort(p, x, cfg, generator, use_kernels)
    return moe_ffn_dense(p, x, cfg, generator, use_kernels)


def init_ffn(generator: torch.Generator, cfg: ModelConfig, *,
             device: torch.device | str, lead: tuple[int, ...] = ()) -> dict:
    if cfg.moe is not None:
        return init_moe(generator, cfg, device=device, lead=lead)
    return init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, cfg.dtype,
                    device=device, lead=lead)


def ffn(p: dict, x: torch.Tensor, cfg: ModelConfig,
        generator: torch.Generator | None = None, use_kernels: bool = False):
    """FFN → (out, aux metrics): the MoE layer for MoE configs, else the
    dense MLP."""
    if cfg.moe is not None:
        return moe_ffn(p, x, cfg, generator, use_kernels)
    return mlp(p, x, cfg.act), {}
