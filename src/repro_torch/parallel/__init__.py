"""The distribution layer: the JAX package's ``parallel/`` on
``torch.distributed``.

``sharding`` holds the rules (specs as tuples) and their ``DTensor``
placements; ``collectives`` and ``pipeline`` are per-rank code over a mesh
dim's process group.  The reference's ``compat.py`` has no counterpart:
its ``shard_map`` wraps a function so that it runs once per device on its
local shard, which is what every torch rank already does, and its
``axis_size`` is ``mesh.size(dim)`` here.
"""
from .sharding import (
    activation_rules,
    batch_specs,
    cache_specs,
    param_shardings,
    safe_spec,
)

__all__ = ["activation_rules", "batch_specs", "cache_specs",
           "param_shardings", "safe_spec"]
