from .utils import act_fn, cdiv, map_leaves, map_trees, round_up, tree_leaves

__all__ = ["act_fn", "cdiv", "map_leaves", "map_trees", "round_up",
           "tree_leaves"]
