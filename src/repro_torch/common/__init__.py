from .utils import act_fn, cdiv, map_leaves, round_up

__all__ = ["act_fn", "cdiv", "map_leaves", "round_up"]
