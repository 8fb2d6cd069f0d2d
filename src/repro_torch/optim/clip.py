"""Global-norm gradient clipping (the reference's ``optim/clip.py``;
paper: max norm 0.25)."""
from __future__ import annotations

import torch

from ..common import map_trees, tree_leaves


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return map_trees(lambda g: (g.float() * scale).to(g.dtype), grads), norm
