"""Small shared utilities (a copy of the reference's ``common/utils.py``
pieces the port needs; no device state touched at import)."""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch
import torch.nn.functional as F


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The reference's activations; its gelu is the tanh approximation."""
    return {
        "relu": F.relu,
        "gelu": functools.partial(F.gelu, approximate="tanh"),
        "silu": F.silu,
        "softmax": lambda x: torch.softmax(x, dim=-1),
        "identity": lambda x: x,
    }[name]


def map_leaves(tree, fn: Callable[[tuple, Any], Any], path: tuple = ()):
    """Apply ``fn(path, leaf)`` to every leaf of nested dicts and lists
    (the port's parameter trees); ``path`` holds the keys and indices."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts and lists, in ``map_leaves`` order."""
    out = []
    map_leaves(tree, lambda path, leaf: out.append(leaf))
    return out


def map_trees(fn: Callable[..., Any], tree, *others):
    """``fn(leaf, *other_leaves)`` over trees of one structure (the first
    tree's)."""
    if isinstance(tree, dict):
        return {k: map_trees(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_trees(fn, v, *(o[i] for o in others))
                for i, v in enumerate(tree)]
    return fn(tree, *others)
