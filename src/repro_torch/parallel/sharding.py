"""Sharding rule engine: FSDP × TP × EP × SP over the production mesh, the
JAX package's ``parallel/sharding.py`` on ``DeviceMesh`` and ``DTensor``.

Strategy (the reference's DESIGN.md §6):
  * params — TP (Megatron column/row split) over ``model``; FSDP (ZeRO-3)
    over the data-parallel dims on the non-TP dim; experts over ``model``
    (EP).  Rules match on the parameter's path suffix (:func:`..utils.tree.
    keystr`, spelled as the reference's); any sharding whose dimension does
    not divide the mesh dims' size is dropped (``safe_spec``).
  * activations — logical-axis rules consumed by ``repro_torch.utils.shard``:
    batch→dp, heads/kv_heads/mlp/expert/vocab→model, seq→data only in the
    long-context (batch=1) decode cells (sequence parallelism).
  * KV caches — batch→dp when divisible, kv-heads→model when divisible,
    sequence→data for batch=1 cells.

A spec is a tuple with one entry per tensor dim: None, a mesh dim name, or
a tuple of names (the reference's ``PartitionSpec``).  The rules read only
the mesh's dim names and sizes.  :func:`to_placements` turns a spec into
one ``Shard``/``Replicate`` per mesh dim: a tensor dim over several mesh
dims is split in mesh order, so ``("pod", "data")`` is pod-major, as JAX
lays out ``P(("pod", "data"))``.  :func:`place` / :func:`place_tree` make
``DTensor``s of a spec: from the full value every rank holds (each keeps
its own slice, nothing is sent), or on the meta device for the dry-run.
"""
from __future__ import annotations

import re
from typing import Any, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ModelConfig, ShapeCell
from ..utils.tree import (_LEAF, _is_namedtuple, keystr, tree_flatten,
                          tree_leaves, tree_map, tree_map_with_path,
                          tree_unflatten)


def mesh_sizes(mesh) -> dict[str, int]:
    """Mesh dim name → size."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_sizes(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def safe_spec(mesh, shape: Sequence[int], *axes) -> tuple:
    """A spec that drops any mesh dims not dividing their tensor dim."""
    sizes = mesh_sizes(mesh)
    out: list = []
    used: set[str] = set()
    for dim, ax in zip(shape, axes):
        if ax is None:
            out.append(None)
            continue
        ax_t = (ax,) if isinstance(ax, str) else tuple(ax)
        ax_t = tuple(a for a in ax_t if a in sizes and a not in used)
        if ax_t and dim % _axis_size(mesh, ax_t) == 0:
            out.append(ax_t if len(ax_t) > 1 else ax_t[0])
            used.update(ax_t)
        else:
            out.append(None)
    return tuple(out)


# -- parameter rules ----------------------------------------------------------
# (path-suffix regex, role); roles resolved per-shape below.
_PARAM_RULES: list[tuple[str, str]] = [
    (r"experts.*gate|experts.*up", "expert_in"),     # [E, d, f]
    (r"experts.*down", "expert_out"),                # [E, f, d]
    (r"embed.*table|head.*table", "embedding"),      # [V, d]
    (r"(wq_b|wk_b|wv_b)", "col"),                    # MLA up-proj [r, H*dh]
    (r"(wq_a|wkv_a)", "vec_in"),                     # MLA down-proj [d, r]
    (r"attn.*wo|out_proj|cm_v|time_mix.*wo", "row"),  # [model_dim, d]
    (r"(wq|wk|wv|wg|wr|gate|up|in_proj|cm_k|frontend|proj1|proj2)", "col"),
    (r"(w_lora_a|w_lora_b|x_proj|router|conv_w|mtp.*proj)", "vec_in"),
    (r"down", "row"),
]


def _spec_for(mesh, path: str, shape: tuple[int, ...], dp, tp) -> tuple:
    ndim = len(shape)
    role = None
    for pat, r in _PARAM_RULES:
        if re.search(pat, path):
            role = r
            break

    # leading layer-stack dims: the rules describe the trailing dims
    def lead(n: int) -> list:
        return [None] * (ndim - n)

    if role == "expert_in" and ndim >= 3:
        return safe_spec(mesh, shape, *lead(3), tp, dp, None)
    if role == "expert_out" and ndim >= 3:
        return safe_spec(mesh, shape, *lead(3), tp, None, dp)
    if role == "embedding" and ndim >= 2:
        return safe_spec(mesh, shape, *lead(2), tp, dp)
    if role == "col" and ndim >= 2:
        return safe_spec(mesh, shape, *lead(2), dp, tp)
    if role == "row" and ndim >= 2:
        return safe_spec(mesh, shape, *lead(2), tp, dp)
    if role == "vec_in" and ndim >= 2:
        return safe_spec(mesh, shape, *lead(2), dp, None)
    if ndim >= 2:
        return safe_spec(mesh, shape, *lead(2), None, dp)
    return (None,) * ndim


def param_shardings(mesh, params_shapes: Any, fsdp: bool = True,
                    tensor_parallel: bool = True,
                    expert_2d: bool = False) -> Any:
    """A spec tree for a param tree (tensors of any device, meta too).

    ``expert_2d`` (§Perf): shard the expert axis over data×model jointly —
    each chip owns whole experts, so expert weights are never gathered;
    tokens move via all-to-all instead (the EP-for-decode layout)."""
    names = mesh.mesh_dim_names
    dp = tuple(a for a in ("pod", "data") if a in names) if fsdp else None
    tp = "model" if tensor_parallel else None
    ep = (tuple(a for a in ("pod", "data") if a in names) + ("model",)
          if expert_2d else tp)

    def assign(path, leaf):
        p = keystr(path)
        if expert_2d and re.search(r"experts", p):
            lead = [None] * (leaf.dim() - 3)
            return safe_spec(mesh, leaf.shape, *lead, ep, None, None)
        return _spec_for(mesh, p, tuple(leaf.shape), dp, tp)

    return tree_map_with_path(assign, params_shapes)


# -- activation logical rules --------------------------------------------------

def activation_rules(mesh, cell: ShapeCell | None = None,
                     tensor_parallel: bool = True,
                     sequence_parallel: bool = False,
                     expert_2d: bool = False) -> dict[str, Any]:
    """Logical-axis → mesh-dim mapping for ``repro_torch.utils.shard``.

    ``tensor_parallel=False`` (§Perf: tiny models on big meshes) drops every
    model-dim activation constraint — combined with TP-free param
    shardings this removes per-layer activation exchanges entirely.
    ``sequence_parallel`` = Megatron-SP: the residual stream's seq axis
    shards over `model` between attention/MLP regions.
    """
    dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    long_ctx = cell is not None and cell.global_batch < _axis_size(mesh, dp)
    tp = "model" if tensor_parallel else None
    # with TP off the model dim is idle for activations — fold it into the
    # batch axes (pure DP over the whole mesh)
    batch_axes = dp if tensor_parallel else dp + ("model",)
    seq = dp if long_ctx else ("model" if (sequence_parallel and tensor_parallel)
                               else None)
    return {
        "batch": None if long_ctx else batch_axes,
        "seq": seq,
        "embed": None,
        "heads": tp,
        "kv_heads": tp,
        "mlp": tp,
        "expert": (dp + ("model",)) if expert_2d else tp,
        "vocab": tp,
    }


# -- input/cache specs ---------------------------------------------------------

def batch_specs(mesh, cfg: ModelConfig, inputs: dict[str, torch.Tensor],
                cell: ShapeCell, tensor_parallel: bool = True
                ) -> dict[str, tuple]:
    dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    if not tensor_parallel:
        dp = dp + ("model",)
    seq_parallel = cell.global_batch < _axis_size(mesh, dp)
    out = {}
    for name, x in inputs.items():
        nd = x.dim()
        if seq_parallel and nd >= 2:
            # batch=1 long-context: shard the sequence axis instead (SP)
            axes = [None, dp] + [None] * (nd - 2)
        elif seq_parallel:
            axes = [None] * nd
        else:
            axes = [dp] + [None] * (nd - 1)
        out[name] = safe_spec(mesh, x.shape, *axes)
    return out


def cache_specs(mesh, cfg: ModelConfig, caches_shapes: Any,
                cell: ShapeCell) -> Any:
    """Specs for decode caches.

    KV tensors [L, B, S, KVH, D] (GQA) / [L, B, S, R] (MLA) / states.
    batch→dp when divisible; kv_heads→model when divisible; for batch=1
    long-context cells the sequence axis shards over data (SP decode).
    """
    dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    seq_parallel = cell.global_batch < _axis_size(mesh, dp)
    cache_seq = cell.seq_len + cfg.meta_tokens

    def assign(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 3 and shape[2] == cache_seq:
            # quantization scales [L, B, T]
            return safe_spec(mesh, shape, None,
                             None if seq_parallel else dp,
                             dp if seq_parallel else None)
        if nd >= 4 and shape[2] == cache_seq:
            # KV cache [L, B, S, KVH, D] (GQA) or [L, B, S, R] (MLA)
            axes: list = [None,
                          None if seq_parallel else dp,
                          dp if seq_parallel else None]
            axes += (["model", None] if nd == 5 else [None] * (nd - 3))
            return safe_spec(mesh, shape, *axes)
        # states / misc [L, B, feat...]: batch over dp, first feature → model
        axes = [None, None if seq_parallel else dp] + [None] * (nd - 2)
        if nd >= 3:
            axes[2] = "model"
        return safe_spec(mesh, shape, *axes)

    return tree_map(assign, caches_shapes)


# -- specs → DTensors ----------------------------------------------------------

def to_placements(mesh, spec: Sequence) -> list:
    """One placement per mesh dim: ``Shard(d)`` where tensor dim ``d``'s
    entry names it, else ``Replicate()``.  A dim over several mesh dims
    must list them in mesh order (that split is the only one a placement
    list spells).  A mesh dim of size 1 holds the whole tensor either way
    and is ``Replicate()`` (older ``DTensor``s refuse views that merge two
    dims sharded even over one rank)."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"dim order {tuple(names)}")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return out


def local_region(mesh, shape: Sequence[int],
                  placements: Sequence) -> list[tuple[int, int]]:
    """(start, length) per tensor dim of this rank's shard."""
    coord = mesh.get_coordinate()
    index = [0] * len(shape)
    parts = [1] * len(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            index[pl.dim] = index[pl.dim] * mesh.size(i) + coord[i]
            parts[pl.dim] *= mesh.size(i)
    region = []
    for n, k, c in zip(shape, index, parts):
        if n % c:
            raise ValueError(f"dim of {n} does not split evenly in {c}")
        region.append((k * (n // c), n // c))
    return region


def place(x: torch.Tensor, mesh, spec: Sequence) -> DTensor:
    """``x`` as a ``DTensor`` laid out by ``spec``.  ``x`` is the full value,
    the same on every rank, and each rank keeps its own slice; a meta ``x``
    gives a meta ``DTensor`` of the same global shape."""
    placements = to_placements(mesh, spec)
    region = local_region(mesh, x.shape, placements)
    if x.is_meta:
        local = torch.empty([n for _, n in region], dtype=x.dtype,
                            device="meta")
    else:
        local = x
        for d, (start, n) in enumerate(region):
            local = local.narrow(d, start, n)
        local = local.contiguous()
    return DTensor.from_local(local, mesh, placements, shape=x.shape,
                              stride=torch.empty(x.shape,
                                                 device="meta").stride(),
                              run_check=False)


def spec_leaves(tree: Any, specs: Any) -> list:
    """The specs of ``tree``'s leaves, in leaf order.  A spec is a tuple, so
    the spec tree is walked by ``tree``'s structure, not flattened."""
    def walk(sub, t):
        if t is _LEAF:
            return [sub]
        if isinstance(t, dict):
            return [s for k in t for s in walk(sub[k], t[k])]
        if _is_namedtuple(t) or isinstance(t, (list, tuple)):
            return [s for sub_i, t_i in zip(sub, t) for s in walk(sub_i, t_i)]
        return []
    out = walk(specs, tree_flatten(tree)[1])
    if len(out) != len(tree_leaves(tree)):
        raise ValueError("the spec tree does not match the tree")
    return out


def place_tree(tree: Any, specs: Any, mesh) -> Any:
    """:func:`place` over a tree and its spec tree."""
    leaves, tdef = tree_flatten(tree)
    return tree_unflatten(tdef, [place(x, mesh, s) for x, s
                                 in zip(leaves, spec_leaves(tree, specs))])
