"""Logical-axis sharding constraints: the JAX package's
``utils/sharding_ctx.py`` on ``DTensor``.

Models annotate activations with *logical* axis names:

    x = shard(x, "batch", "seq", "embed")

Inside a ``logical_axis_rules({...}, mesh)`` context (entered by the
dry-run or a sharded step with the active ``DeviceMesh``), each logical
name maps to a mesh dim (or None) and the annotation redistributes a
``DTensor`` to that layout, where the reference calls
``jax.lax.with_sharding_constraint``.  Outside any context (every serving,
training and unit-test path) the call returns ``x`` itself, so model code
is mesh-agnostic.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_state = threading.local()


def current_rules() -> dict[str, object] | None:
    return getattr(_state, "rules", None)


def _current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def logical_axis_rules(rules: Mapping[str, str | Sequence[str] | None] | None,
                       mesh=None):
    """Rules (and the mesh they name) for the ``shard`` calls made inside;
    ``None`` turns them off (per-shard code)."""
    prev_r = getattr(_state, "rules", None)
    prev_m = getattr(_state, "mesh", None)
    _state.rules = None if rules is None else dict(rules)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.rules = prev_r
        _state.mesh = prev_m


def logical_to_spec(axes: Sequence[str | None],
                    rules: Mapping[str, object]) -> tuple:
    """The spec of ``axes`` under ``rules``: one entry per dim, each None,
    a mesh dim name or a tuple of names; a mesh dim is used once, by the
    first logical axis that claims it."""
    spec: list = []
    used: set[str] = set()
    for a in axes:
        m = rules.get(a) if a is not None else None
        if isinstance(m, (list, tuple)):
            m = tuple(x for x in m if x not in used)
            used.update(m)
            # PartitionSpec's canonical form: one name bare, none None
            spec.append(m if len(m) > 1 else (m[0] if m else None))
        else:
            if m in used:
                m = None
            if m is not None:
                used.add(m)
            spec.append(m)
    return tuple(spec)


def divisible_spec(shape: Sequence[int], spec: Sequence,
                   sizes: Mapping[str, int]) -> tuple:
    """``spec`` with every entry whose mesh dims do not divide their tensor
    dim dropped (the reference's partial shardings force remat copies; a
    ``DTensor`` shard must be even for the model's views)."""
    cleaned: list = []
    for dim, entry in zip(shape, spec):
        ax = (entry,) if isinstance(entry, str) else entry
        if ax is None:
            cleaned.append(None)
            continue
        total = 1
        for a in ax:
            total *= sizes.get(a, 1)
        cleaned.append(entry if dim % total == 0 else None)
    return tuple(cleaned)


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Lay ``x`` out by its logical ``axes``; ``x`` itself without active
    rules, and for a plain tensor (per-shard code, and whatever the model
    makes that no param or input reaches).

    Under rules a ``DTensor`` is redistributed to the spec's placements on
    the context's mesh (else its own), after the divisibility drop."""
    rules = current_rules()
    if rules is None:
        return x
    if x.dim() != len(axes):
        raise ValueError(f"rank {x.dim()} vs {len(axes)} logical axes")
    if not isinstance(x, DTensor):
        return x
    from ..parallel.sharding import to_placements
    mesh = _mesh_for(x)
    spec = _layout(x.shape, axes, rules, mesh)
    return x.redistribute(mesh, to_placements(mesh, spec))


def _mesh_for(x: DTensor):
    """The context's mesh, else the ``DTensor``'s own."""
    mesh = _current_mesh()
    return x.device_mesh if mesh is None else mesh


def _layout(shape: Sequence[int], axes: Sequence, rules, mesh) -> tuple:
    """The spec of ``axes`` for ``shape`` on ``mesh``, after the drop."""
    from ..parallel.sharding import mesh_sizes
    return divisible_spec(shape, logical_to_spec(axes, rules),
                          mesh_sizes(mesh))


def shard_split(x: torch.Tensor, shape: Sequence[int],
                *axes: str | None) -> torch.Tensor:
    """``shard(x.reshape(shape), *axes)`` for a view that splits ``x``'s
    last dim in two (heads × head dim; ``axes[-1]`` must map to nothing).
    A ``DTensor`` view cannot reshard, where GSPMD would: so under rules
    ``x`` is first laid out with its last dim split as the first factor
    will be, which is a whole number of heads a shard or none."""
    rules = current_rules()
    if rules is None:
        return x.reshape(shape)
    if isinstance(x, DTensor):
        spec = _layout(shape, axes, rules, _mesh_for(x))
        if spec[-1] is not None:
            raise ValueError("shard_split keeps the last factor whole")
        x = shard(x, *axes[:-2], None if spec[-2] is None else axes[-2])
    return shard(x.reshape(shape), *axes)


def shard_merge(x: torch.Tensor, shape: Sequence[int],
                *axes: str | None) -> torch.Tensor:
    """``x.reshape(shape)`` merging ``x``'s last two dims (heads × head
    dim), annotated with ``axes``: the merged dim takes ``axes[-1]``'s mesh
    dims only where they split ``x``'s heads evenly.  Its backward lays
    the incoming grad out the same way before the view back to heads,
    which ``DTensor`` cannot reshard (a row-parallel projection's grad
    arrives sharded over the flat dim)."""
    rules = current_rules()
    y = x.reshape(shape)
    if rules is None:
        return y
    if isinstance(x, DTensor):
        heads = _layout(x.shape, axes + (None,), rules, _mesh_for(x))[-2]
        axes = axes[:-1] + (axes[-1] if heads is not None else None,)
    return shard(y, *axes)


def whole_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dim ``dim`` on every rank whole: a ``DTensor`` split
    there is gathered along it (other dims keep their layout); anything
    else is returned as it is.  For the ops ``DTensor`` cannot run on a
    split dim and GSPMD reshards for (a gather along the vocab)."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.dim()
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl)


def whole(x: torch.Tensor) -> torch.Tensor:
    """``x`` replicated on every rank of its mesh (a plain tensor as it
    is)."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def write_slots(cache: torch.Tensor, pos: torch.Tensor,
                new: torch.Tensor) -> None:
    """``cache[i, pos[i]] = new[i]`` for every row ``i`` of a dense slab
    ``[B, T, ...]``, in place.  A ``DTensor`` slab is written shard by
    shard with no data moved but the new rows: each rank writes its own
    rows, and where T is sharded (long-context decode) only the rank that
    holds ``pos[i]``; DTensor itself refuses an in-place write that would
    change the slab's placements."""
    if not isinstance(cache, DTensor):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache.index_put_((rows, pos), new.to(cache.dtype))
        return
    from ..parallel.sharding import local_region
    mesh, pl = cache.device_mesh, cache.placements
    if any(not isinstance(p, (Shard, Replicate)) for p in pl):
        raise ValueError(f"cannot write into a slab placed {pl}")
    row_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in pl]
    new_pl = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2
              else q for p, q in zip(pl, row_pl)]
    new_l = _as_dtensor(new, mesh).redistribute(mesh, new_pl).to_local()
    pos_l = _as_dtensor(pos, mesh).redistribute(mesh, row_pl).to_local()
    local = cache.to_local()
    t0, tn = local_region(mesh, cache.shape, pl)[1]
    col = pos_l.long() - t0
    ok = (col >= 0) & (col < tn)
    col = col.clamp(0, tn - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    ok = ok.reshape(ok.shape + (1,) * (new_l.dim() - 1))
    local.index_put_((rows, col), torch.where(ok, new_l.to(local.dtype),
                                              local[rows, col]))


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; a ``DTensor`` ``src`` is first laid out as
    ``dst`` is (DTensor refuses a copy that changes ``dst``'s placements)."""
    if isinstance(dst, DTensor):
        src = _as_dtensor(src, dst.device_mesh).redistribute(
            dst.device_mesh, dst.placements)
    dst.copy_(src)


def _as_dtensor(x: torch.Tensor, mesh):
    """``x`` itself if a ``DTensor``, else the same value replicated."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _DenseGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous grad: a local grad
    going back into a ``DTensor`` is taken as laid out by the global
    shape's strides, which later views rely on."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def seq_split(*xs: torch.Tensor) -> bool:
    """Whether a ``DTensor`` among ``xs`` splits its dim 1 (a sequence,
    under sequence parallelism)."""
    return any(isinstance(x, DTensor) and Shard(1) in x.placements
               for x in xs)


def on_local_shards(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """``fn(q, k, v, mask)``, an attention over ``q [B,S,H,Dk]``, ``k
    [B,T,KVH,Dk]``, ``v [B,T,KVH,Dv]`` → ``[B,S,H,Dv]``, run by each rank
    on its own shards of ``DTensor`` operands, as GSPMD partitions it.

    The batch (dim 0) and the heads (dim 2) keep the mesh dims ``q`` splits
    them over; every other dim is made whole.  K/V split their heads
    alike, or stay whole when there is one KV head (MLA's latent, which
    every query head reads); a head split that does not divide KVH is made
    whole; a batch split only K/V carry is taken too.  A ``[B,S,T]`` mask
    follows the batch, an ``[S,T]`` one stays whole.  Not for a split
    sequence (``seq_split``), whose softmax spans ranks.  Inside, ``fn`` sees plain tensors and no rules; the result is a
    ``DTensor`` laid out as ``q`` was taken.  Attention is independent per
    (row, head), so nothing moves but the redistributions in; ``DTensor``
    itself would flatten the split batch and head dims into one bmm batch,
    which torch 2.11 refuses."""
    mesh = q.device_mesh
    head_split = [i for i, p in enumerate(q.placements)
                  if isinstance(p, Shard) and p.dim == 2]
    n_head = 1
    for i in head_split:
        n_head *= mesh.size(i)
    kvh = k.shape[2]
    if kvh != 1 and kvh % n_head:
        head_split = []
    k_pl = k.placements if isinstance(k, DTensor) else ()

    def place(i, p):
        if isinstance(p, Shard) and (p.dim == 0 or (
                p.dim == 2 and i in head_split)):
            return p
        # a batch split only K/V carry (decode: the cache is the big one)
        if i < len(k_pl) and k_pl[i] == Shard(0) and p != Shard(2):
            return Shard(0)
        return Replicate()
    q_pl = [place(i, p) for i, p in enumerate(q.placements)]
    row_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in q_pl]
    kv_pl = row_pl if kvh == 1 else q_pl
    # one KV head read by every rank's query heads: each rank's K/V grad
    # is its heads' share, summed over the head split
    kv_grad = [Partial() if kvh == 1 and i in head_split else p
               for i, p in enumerate(kv_pl)]
    local = [_DenseGrad.apply(_as_dtensor(x, mesh).redistribute(
        mesh, pl).to_local(grad_placements=gp))
        for x, pl, gp in ((q, q_pl, q_pl), (k, kv_pl, kv_grad),
                          (v, kv_pl, kv_grad))]
    if mask is not None:
        mask = _as_dtensor(mask, mesh).redistribute(
            mesh, row_pl if mask.dim() == 3 else [Replicate()] * mesh.ndim
        ).to_local()
    with logical_axis_rules(None):
        out = fn(*local, mask).contiguous()   # the strides from_local states
    shape = q.shape[:3] + out.shape[3:]
    return DTensor.from_local(out, mesh, q_pl, shape=shape,
                              stride=torch.empty(shape, device="meta").stride(),
                              run_check=False)

