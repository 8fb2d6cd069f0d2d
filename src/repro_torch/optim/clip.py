"""Global-norm gradient clipping (the reference's ``optim/clip.py``;
paper: max norm 0.25). Under a mesh the gradients are reduced already:
every rank holds the replicated leaves whole and its shard of each expert
leaf, so the norm counts the replicated leaves once and sums the expert
shards' squares over the "model" axis."""
from __future__ import annotations

import torch

from ..common import map_trees, tree_leaves
from ..sharding import all_reduce_


def global_norm(tree, sharded=None, group=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in leaf order. ``sharded``
    (a tree of bools like ``tree``) marks the leaves whose squares are
    summed over ``group`` first."""
    squares = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    marks = tree_leaves(sharded) if sharded is not None else [False] * len(squares)
    split = [i for i, m in enumerate(marks) if m]
    if split and group is not None:
        summed = all_reduce_(torch.stack([squares[i] for i in split]), group)
        for j, i in enumerate(split):
            squares[i] = summed[j]
    return torch.sqrt(sum(squares))


def clip_by_global_norm(grads, max_norm: float, sharded=None, group=None):
    """Returns (clipped grads, the norm before clipping)."""
    norm = global_norm(grads, sharded, group)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return map_trees(lambda g: (g.float() * scale).to(g.dtype), grads), norm
