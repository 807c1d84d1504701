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
from torch.distributed.tensor import DTensor, Replicate

from ..configs.base import ModelConfig
from ..utils import shard
from ..utils.sharding_ctx import on_local_shards, whole
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
    """Router (fp32 weights and a zero balancing bias, over all experts),
    stacked expert weights ``[*lead, E, ...]`` in the config's dtype (E the
    held experts where the config names them, else every expert), the
    shared expert."""
    e = cfg.moe
    d, dtype = cfg.d_model, cfg.dtype
    n_held = held_experts(e)[1]
    device = check_device(device)
    p = {
        "router": {
            "w": torch.randn(lead + (d, e.n_experts), generator=generator,
                             dtype=torch.float32, device=device) * d ** -0.5,
            "bias": torch.zeros(lead + (e.n_experts,), dtype=torch.float32,
                                device=device),
        },
        "experts": {
            "gate": _expert_stack(generator, lead + (n_held, d, e.d_expert),
                                  d ** -0.5, dtype, device),
            "up": _expert_stack(generator, lead + (n_held, d, e.d_expert),
                                d ** -0.5, dtype, device),
            "down": _expert_stack(generator, lead + (n_held, e.d_expert, d),
                                  e.d_expert ** -0.5, dtype, device),
        },
    }
    if e.n_shared:
        p["shared"] = init_mlp(generator, d, e.d_expert * e.n_shared,
                               "swiglu", dtype, device=device, lead=lead)
    return p


def held_experts(e) -> tuple[int, int]:
    """(first, count) of the experts this chip holds: the ``held_experts``
    of rank ``expert_rank``, or every expert where none are named."""
    if not e.held_experts:
        return 0, e.n_experts
    first = e.expert_rank * e.held_experts
    if e.n_experts % e.held_experts or not 0 <= first < e.n_experts:
        raise ValueError(f"{e.held_experts} held experts of rank "
                         f"{e.expert_rank} do not divide {e.n_experts}")
    return first, e.held_experts


def _group_limit(select: torch.Tensor, n_group: int,
                 topk_group: int) -> torch.Tensor:
    """``select [N, E]`` with every expert outside a token's ``topk_group``
    best groups at -inf; a group (E / n_group experts in a row) scores the
    sum of its two best selection scores."""
    n, e = select.shape
    grouped = select.reshape(n, n_group, e // n_group)
    score = grouped.topk(min(2, e // n_group), dim=-1).values.sum(-1)
    keep = torch.zeros_like(score, dtype=torch.bool).scatter_(
        1, score.topk(topk_group, dim=-1).indices, True)
    return grouped.masked_fill(~keep[..., None],
                               float("-inf")).reshape(n, e)


def select_experts(logits: torch.Tensor, bias: torch.Tensor, e,
                   noise: torch.Tensor | None = None):
    """The routing rule, from fp32 router ``logits [N, E]`` → (scores [N,E],
    combine weights [N,k], experts [N,k]).  Aux-loss-free configs score by
    sigmoid and select on the scores plus the balancing ``bias`` (softmax
    scores alone otherwise), ``noise`` added to the selection; with
    ``n_group`` > 1 the top-k is taken inside each token's ``topk_group``
    best groups (DeepSeek-V3's noaux_tc); the combine weights are the
    unbiased scores of the selected experts, normalised, times
    ``routed_scaling_factor``."""
    scores = (torch.sigmoid(logits) if e.router_aux_free
              else torch.softmax(logits, dim=-1))
    select = scores + bias[None, :] if e.router_aux_free else scores
    if noise is not None:
        select = select + noise
    if e.n_group > 1:
        select = _group_limit(select, e.n_group, e.topk_group)
    top_idx = torch.topk(select, e.top_k, dim=-1).indices           # [N,k]
    top_w = torch.gather(scores, -1, top_idx)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    if e.routed_scaling_factor != 1.0:
        top_w = top_w * e.routed_scaling_factor
    return scores, top_w, top_idx


def route(p_router: dict, x: torch.Tensor, e,
          generator: torch.Generator | None = None):
    """Top-k routing of ``x [N, d]`` → (weights [N,k], experts [N,k], aux)
    by :func:`select_experts`.  With ``generator`` and a nonzero
    ``router_noise``, Gaussian noise is added to the selection scores."""
    logits = matmul_f32(x.float(), p_router["w"])
    noise = None
    if generator is not None and e.router_noise > 0:
        noise = torch.randn(logits.shape, generator=generator,
                            device=logits.device) * e.router_noise
    scores, top_w, top_idx = select_experts(logits, p_router["bias"], e,
                                            noise)
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


# -- the expert-parallel layer: a chip's held experts, no pair dropped ---------
#
# The held experts' rows live in a static buffer of every token per expert
# (``[H, N, d]``, so no routed pair is ever dropped), their counts on the
# device: nothing here waits on the host, so the layer records into a CUDA
# graph.  A row past its expert's count holds some token (it is never read
# back); the combine reads a held expert's row only for a token routed to it.

def held_plan(top_idx: torch.Tensor, first: int, held: int) -> torch.Tensor:
    """[H, N + 1] int64 for the held experts ``first`` .. ``first + held -
    1``: row r of held expert j is token ``plan[j, r]`` (its routed tokens
    first, in token order, then the others), and ``plan[j, N]`` counts its
    routed tokens."""
    hit = ((top_idx - first)[..., None]
           == torch.arange(held, device=top_idx.device)).any(dim=1)  # [N,H]
    order = torch.argsort((~hit).to(torch.uint8), dim=0, stable=True)
    return torch.cat([order.t(), hit.sum(0)[:, None]], dim=1)


def held_dispatch(xf: torch.Tensor, plan: torch.Tensor) -> torch.Tensor:
    """The held experts' input rows ``[H, N, d]`` from tokens ``xf [N, d]``
    (one row gather)."""
    h, n = plan.shape[0], plan.shape[1] - 1
    return torch.index_select(xf, 0, plan[:, :-1].reshape(-1)).view(
        h, n, xf.shape[-1])


def held_counts(plan: torch.Tensor) -> torch.Tensor:
    return plan[:, -1].to(torch.int32)


def held_mlp(p_experts: dict, buf: torch.Tensor, counts: torch.Tensor,
             use_kernels: bool) -> torch.Tensor:
    """The held experts' SwiGLU over the first ``counts[j]`` rows of each
    ``buf[j]`` → ``[H·N + 1, d]``: expert j's rows at ``j·N ..``, the rows
    past a count left as they are, and a last row of zeros (what a token
    not routed to an expert reads)."""
    h, n, d = buf.shape
    out = torch.empty((h * n + 1, d), dtype=buf.dtype, device=buf.device)
    out[-1].zero_()
    rows = out[:-1].view(h, n, d)
    if use_kernels:
        from ..kernels.moe_gemm import moe_mlp
        moe_mlp(buf, p_experts["gate"], p_experts["up"], p_experts["down"],
                counts=counts, out=rows)
    else:
        rows.copy_(_expert_mlp(p_experts, buf, False))
    return out


def held_combine(out: torch.Tensor, top_w: torch.Tensor,
                 top_idx: torch.Tensor, plan: torch.Tensor, first: int,
                 held: int) -> torch.Tensor:
    """``y[n] = Σ_j w[n, j] · out[j, rank of n in j]`` over the held experts
    that token n is routed to, from :func:`held_mlp`'s rows and the
    :func:`held_plan` that placed them → [N, d] in their dtype (one row
    gather, then the products summed in fp32, rounded once).  A held
    expert a token is not routed to reads the zero row with a zero weight,
    so no row past a count is read."""
    n = top_idx.shape[0]
    local = top_idx - first
    onehot = local[..., None] == torch.arange(held, device=top_idx.device)
    w = (top_w[..., None] * onehot).sum(dim=1)                       # [N,H]
    tokens = plan[:, :-1]
    rank = torch.empty_like(tokens).scatter_(
        1, tokens, torch.arange(n, device=plan.device).expand(held, n))
    row = torch.where(rank < plan[:, -1:],
                      torch.arange(held, device=plan.device)[:, None] * n
                      + rank, out.shape[0] - 1)                      # [H,N]
    rows = torch.index_select(out, 0, row.t().reshape(-1))
    return torch.bmm(w.to(out.dtype)[:, None, :],
                     rows.view(n, held, out.shape[-1]))[:, 0]


def moe_ffn_held(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 generator: torch.Generator | None = None,
                 use_kernels: bool = False):
    """The expert-parallel layer: routing over all experts, the held
    experts' part of the result for every pair routed to them (none
    dropped), plus the shared expert; the absent experts add nothing."""
    e = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    top_w, top_idx, aux = route(p["router"], xf, e, generator)
    first, held = held_experts(e)
    plan = held_plan(top_idx, first, held)
    out = held_mlp(p["experts"], held_dispatch(xf, plan), held_counts(plan),
                   use_kernels)
    y = held_combine(out, top_w, top_idx, plan, first, held)
    if e.n_shared:
        y = y + mlp(p["shared"], xf, "swiglu")
    return y.reshape(b, s, d), aux


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


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *ops)`` in the operands' dtype; ``DTensor``
    operands run on each rank's local shards, where a split contraction
    (a combine over split experts), and an operand's grad that is a sum
    across ranks, are summed in fp32 before the one rounding."""
    if not any(isinstance(t, DTensor) for t in ops):
        return torch.einsum(eq, *ops)

    def f32(*t):
        return torch.einsum(eq, *(u.float() for u in t))

    def local(*t):
        return (torch.einsum(eq, *t) if len({u.dtype for u in t}) == 1
                else f32(*t))
    return on_local_shards(local, eq, *ops, fn_partial=f32,
                           f32_grads=tuple(range(len(ops))),
                           dtype=ops[0].dtype)


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
    comb = _einsum("nke,nkc->nec", disp, poh)                       # [N,E,C]
    buf = _einsum("nec,nd->ecd", comb, xf)                          # [E,C,d]
    buf = shard(buf, "expert", None, None)
    out_buf = shard(_expert_mlp(p["experts"], buf, use_kernels),
                    "expert", None, None)
    comb_w = _einsum("nke,nkc,nk->nec", disp, poh, w.to(xf.dtype))
    y = _einsum("nec,ecd->nd", comb_w, out_buf)
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
    buf = _scatter_dispatch(xf, slot.reshape(n, e.top_k),
                            keep.reshape(n, e.top_k), e.n_experts, cap)
    buf = shard(buf, "expert", None, None)

    out_buf = shard(_expert_mlp(p["experts"], buf, use_kernels),
                    "expert", None, None)

    y = _gather_combine(out_buf, slot.reshape(n, e.top_k),
                        (w_flat * keep).reshape(n, e.top_k).to(xf.dtype))
    if e.n_shared:
        y = y + mlp(p["shared"], xf, "swiglu")
    return y.reshape(b, s, d), aux


def _scatter_dispatch(xf: torch.Tensor, slot: torch.Tensor,
                      keep: torch.Tensor, n_experts: int,
                      cap: int) -> torch.Tensor:
    """The ``[E, C, d]`` capacity buffers: each token's row of ``xf [N, d]``
    at its k slots (``slot``, ``keep`` ``[N, k]``; a pair not kept, whose
    slot is ``E·C``, adds nothing).  ``DTensor`` operands run on each
    rank's local shards: the experts are split as the rules lay them out,
    every rank reads every token, and each fills only its own experts'
    rows, so no rank holds the whole buffer and nothing is summed."""
    def local(x, sl, kp, ids=None):
        n_loc = n_experts if ids is None else ids.numel()
        if ids is not None:           # pairs of other ranks' experts drop
            at = sl - ids[0] * cap
            kp = kp & (at >= 0) & (at < n_loc * cap)
            sl = torch.where(kp, at, n_loc * cap)
        tok = torch.arange(sl.numel(), device=x.device) // sl.shape[1]
        gathered = x[tok] * kp.reshape(-1)[:, None].to(x.dtype)    # [NK,d]
        buf = torch.zeros((n_loc * cap + 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device).index_add(0, sl.reshape(-1),
                                                     gathered)
        return buf[:n_loc * cap].reshape(n_loc, cap, x.shape[-1])

    ops = (xf, slot, keep)
    if not any(isinstance(t, DTensor) for t in ops):
        return local(*ops)
    mesh = next(t for t in ops if isinstance(t, DTensor)).device_mesh
    ids = DTensor.from_local(torch.arange(n_experts, device=xf.device),
                             mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return on_local_shards(local, "nd,nk,nk,e->ecd", *ops,
                           shard(ids, "expert"), split="e", f32_grads=(0,),
                           dtype=xf.dtype)


def _gather_combine(out_buf: torch.Tensor, slot: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """``y[n] = Σ_k out_buf[slot[n, k]] · scale[n, k]``: out_buf ``[E,C,d]``
    read as ``E·C`` rows (a slot past them, a pair over capacity, has a
    zero scale), slot and scale ``[N, k]`` → ``[N, d]``.  ``DTensor``
    operands run on each rank's local shards: with the experts split, a
    rank gathers only the rows of its own experts (zero for the others),
    and the partial sums are summed across ranks in fp32, as GSPMD
    partitions a gather from a split operand; no rank gathers the whole
    buffer."""
    dt = out_buf.dtype

    def local(ob, sl, sc, ids=None):
        ec = ob.shape[0] * ob.shape[1]
        rows = ob.reshape(ec, ob.shape[-1])[torch.clamp(sl, max=ec - 1)]
        return (rows.to(dt) * sc.to(dt)[..., None]).sum(dim=1)

    if not any(isinstance(t, DTensor) for t in (out_buf, slot, scale)):
        return local(out_buf, slot, scale)

    def partial(ob, sl, sc, ids):
        ec = ob.shape[0] * ob.shape[1]
        at = sl - ids[0] * ob.shape[1]        # this rank's experts' rows
        mine = (at >= 0) & (at < ec)
        rows = ob.reshape(ec, ob.shape[-1])[at.clamp(0, ec - 1)]
        return (rows.to(dt) * (sc * mine).to(dt)[..., None]).float().sum(1)
    ids = torch.arange(out_buf.shape[0], device=out_buf.device)
    return on_local_shards(local, "ecd,nk,nk,e->nd", out_buf, slot, scale,
                           ids, fn_partial=partial, f32_grads=(0, 2),
                           dtype=dt)


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig,
            generator: torch.Generator | None = None,
            use_kernels: bool = False):
    if cfg.moe.held_experts:
        return moe_ffn_held(p, x, cfg, generator, use_kernels)
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
