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


class _GradSumF32(torch.autograd.Function):
    """A low-precision ``DTensor`` in fp32, whose grad (a sum over ranks,
    ``Partial``) is summed in fp32 and only then cast back."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements, ctx.dtype = x.placements, x.dtype
        return x.float()

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements).to(ctx.dtype)


def on_local_shards(fn, spec: str, *operands: torch.Tensor | None,
                    split: str | None = None, fn_partial=None,
                    f32_grads: tuple[int, ...] = (),
                    dtype: torch.dtype | None = None):
    """``fn(*operands)`` run by each rank on its own shards of ``DTensor``
    operands, as GSPMD partitions the op that ``spec`` writes in einsum
    notation (``"mk,kn->mn"``; several outputs after ``->`` are comma
    separated, and a ``None`` operand's letters are ignored).

    Each mesh dim keeps one letter split (only letters in ``split``, all
    by default): the first that an operand splits there and an output
    keeps, else the first contracted one, and only where it divides every
    dim that carries it.  Every operand is laid out so: split along that
    letter where it carries it, whole otherwise (its grad is then a sum
    over the split).  A dim whose letter no mesh dim keeps is made whole.
    Inside, ``fn`` sees plain tensors and no rules, and returns one tensor
    or a tuple, one per output.  Where a contracted letter is split, each
    rank's result is a partial sum: ``fn_partial`` runs instead (with an
    fp32 result; without it such a split raises), the sums are reduced in
    fp32 across the ranks, and only then is anything cast to ``dtype``.
    The results are ``DTensor``s, split as the letters they keep.  The
    low-precision operands at the positions ``f32_grads`` whose grad is a
    sum over ranks reach ``fn`` in fp32, so that sum is taken in fp32 and
    rounded once (the backward of such a product, as the reference's
    transposed fp32 dot); ``fn`` then takes mixed dtypes.

    ``DTensor``'s own ops would flatten split dims into one bmm batch
    (torch 2.11 refuses that), round a row-parallel product's partial sums
    before their sum, and have no rule for a product with ``out_dtype``."""
    ins, outs = spec.split("->")
    in_letters, out_letters = ins.split(","), outs.split(",")
    if len(in_letters) != len(operands):
        raise ValueError(f"{spec!r} names {len(in_letters)} operands, "
                         f"got {len(operands)}")
    mesh = next(x for x in operands if isinstance(x, DTensor)).device_mesh
    ops = [(None if x is None else _as_dtensor(x, mesh), lab)
           for x, lab in zip(operands, in_letters)]
    ops_in = [(x, lab) for x, lab in ops if x is not None]
    allowed = set(ins.replace(",", "")) if split is None else set(split)
    kept: list[str | None] = []
    for i in range(mesh.ndim):
        # a strided shard (a view that merged split dims) is no letter's
        # block: it is laid out anew
        cand = [lab[p.dim] for x, lab in ops_in
                for p in (x.placements[i],)
                if type(p) is Shard and lab[p.dim] in allowed]
        cand.sort(key=lambda c: not any(c in o for o in out_letters))
        pick = None
        for c in cand if mesh.size(i) > 1 else ():
            n = mesh.size(i)
            for j, k in enumerate(kept):
                n *= mesh.size(j) if k == c else 1
            if all(x.shape[d] % n == 0 for x, lab in ops_in
                   for d, ch in enumerate(lab) if ch == c):
                pick = c
                break
        kept.append(pick)

    def layout(letters: str, grad: bool) -> list:
        return [Replicate() if c is None
                else Shard(letters.index(c)) if c in letters
                else (Partial() if grad else Replicate()) for c in kept]
    out_pl = [layout(o, True) for o in out_letters]
    partial = any(isinstance(p, Partial) for pl in out_pl for p in pl)
    if partial and fn_partial is None:
        raise ValueError(f"{spec!r} split on a contracted letter "
                         f"{kept}: no fn_partial to run per shard")
    local = []
    for i, (x, lab) in enumerate(ops):
        if x is None:
            local.append(None)
            continue
        want = layout(lab, False)
        t = x if list(x.placements) == want else x.redistribute(mesh, want)
        grad = layout(lab, True)
        if (i in f32_grads and t.requires_grad and torch.is_grad_enabled()
                and t.dtype != torch.float32
                and any(isinstance(p, Partial) for p in grad)):
            t = _GradSumF32.apply(t)
        t = t.to_local(grad_placements=grad)
        local.append(_DenseGrad.apply(t) if t.is_floating_point() else t)
    size = {}
    for x, lab in ops_in:
        for c, n in zip(lab, x.shape):
            size.setdefault(c, n)
    with logical_axis_rules(None):
        res = (fn_partial if partial else fn)(*local)
    single = not isinstance(res, tuple)
    out = []
    for r, letters, pl in zip((res,) if single else res, out_letters,
                              out_pl):
        r = r.contiguous()              # the strides from_local states
        shape = torch.Size(size.get(c, n) for c, n in zip(letters, r.shape))
        y = DTensor.from_local(r, mesh, pl, shape=shape,
                               stride=_dense_stride(shape), run_check=False)
        if any(isinstance(p, Partial) for p in pl):
            y = y.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                      else p for p in pl])
        out.append(y if dtype in (None, y.dtype) else y.to(dtype))
    return out[0] if single else tuple(out)


def _dense_stride(shape: Sequence[int]) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))
