from .sharding_ctx import current_rules, logical_axis_rules, shard
from .tree import (keystr, tree_flatten, tree_leaves, tree_map,
                   tree_map_with_path, tree_param_count, tree_paths,
                   tree_unflatten)

__all__ = ["current_rules", "keystr", "logical_axis_rules", "shard",
           "tree_flatten", "tree_leaves", "tree_map", "tree_map_with_path",
           "tree_param_count", "tree_paths", "tree_unflatten"]
