from .tree import (tree_flatten, tree_leaves, tree_map, tree_param_count,
                   tree_unflatten)

__all__ = ["tree_flatten", "tree_leaves", "tree_map", "tree_param_count",
           "tree_unflatten"]
