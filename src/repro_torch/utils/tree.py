"""Pytree helpers over the port's nested dict / list / tuple trees.

Leaves come in ``jax.tree_util``'s order: dict keys sorted, lists, tuples
and NamedTuples in order, ``None`` an empty node.  The optimizer walks
params, grads and moments in that order, and the checkpointer numbers its
leaves by it, so a checkpoint written by either package restores in the
other.  :func:`keystr` spells a leaf's path as ``jax.tree_util.keystr``
does (``['layers'][0]['attn']['wq']``, a NamedTuple field as ``.name``):
the sharding rules match regexes on those strings, so both packages must
give the same ones.
"""
from __future__ import annotations

from typing import Any, Callable

_LEAF = object()


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree: Any) -> tuple[list, Any]:
    """(leaves in jax's order, spec) — ``spec`` rebuilds the tree from a
    leaf list of the same length (:func:`tree_unflatten`)."""
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if t is None:
            return None
        leaves.append(t)
        return _LEAF
    return leaves, walk(tree)


def tree_unflatten(spec: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(s):
        if s is _LEAF:
            return next(it)
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if _is_namedtuple(s):
            return type(s)(*(build(v) for v in s))
        if isinstance(s, (list, tuple)):
            return type(s)(build(v) for v in s)
        return s
    out = build(spec)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the spec holds")
    return out


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-structured ``rest``."""
    leaves, spec = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees differ in their number of leaves")
    return tree_unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])


def _walk_paths(tree: Any, path: tuple) -> list[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _walk_paths(tree[k], path + (f"[{k!r}]",))]
    if _is_namedtuple(tree):
        return [pl for name, v in zip(tree._fields, tree)
                for pl in _walk_paths(v, path + (f".{name}",))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _walk_paths(v, path + (f"[{i}]",))]
    if tree is None:
        return []
    return [(path, tree)]


def keystr(path: tuple) -> str:
    """A leaf path as ``jax.tree_util.keystr`` spells it."""
    return "".join(path)


def tree_paths(tree: Any) -> list[str]:
    """Every leaf's :func:`keystr`, in leaf order."""
    return [keystr(path) for path, _ in _walk_paths(tree, ())]


def tree_map_with_path(fn: Callable, tree: Any) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``; ``path`` goes to
    :func:`keystr`, as in ``jax.tree_util.tree_map_with_path``."""
    _, spec = tree_flatten(tree)
    return tree_unflatten(spec, [fn(path, leaf) for path, leaf
                                 in _walk_paths(tree, ())])


def tree_param_count(tree: Any) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))
