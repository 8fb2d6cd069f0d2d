"""Error-feedback gradient compression (the reference's
``optim/compress.py``, its single-host roundtrip).

``compress_grads`` sends each gradient leaf through a lossy wire format
and keeps the quantization residual, which is added back into the next
step's gradient (error feedback, Karimireddy et al. 2019), so SGD and
Adam still converge. Modes: "bf16" (a cast) and "int8" (a per-tensor
absmax/127 scale, rounded half to even as ``jnp.round`` does). The train
step applies it after clipping and before AdamW, on one residual per
parameter leaf (``init_compression_state``).

The reference stacks a segment's layers into one leaf (``models/stack.py``
holds them as a list), so its "per-tensor" int8 scale spans every layer
of a segment: the port gives all slices of one stacked leaf
(``stacked_path``) one scale.

Under a mesh the train step compresses the gradients after their
all-reduce, as here; an expert leaf sharded over "model" takes its int8
scale from the whole leaf (the shards' absmax, max-reduced over the
"model" group). The reference's pod tier (``compress_pod_grads``: per-pod
residuals and the quantized cross-pod mean, for a mesh with a 'pod' axis
of more than one) is not ported and raises (ROADMAP.md, queue 1 item 8).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..common import map_leaves, map_trees, tree_leaves
from ..sharding import all_reduce_

# The expert-parameter subtree: the sparse-FFN tables that dominate the
# gradient's bytes under expert parallelism (the pod tier compresses only
# these leaves).
EXPERT_PARAM_NAMES = frozenset(
    {"we1", "we1g", "we2", "keys_a", "keys_b", "values"})

_POD_TIER = ("the pod tier of gradient compression (a mesh with a 'pod' axis of "
             "more than one) is not ported yet (ROADMAP.md, queue 1 item 8)")


def is_expert_leaf(path) -> bool:
    """Whether the leaf at ``path`` (keys and list indices, as
    ``map_leaves`` gives them) is an expert table: its last key names one."""
    name = next((key for key in reversed(path) if isinstance(key, str)), "")
    return name in EXPERT_PARAM_NAMES


def init_compression_state(params, pod: int = 1):
    """Zero float32 residuals, one of each parameter leaf's shape."""
    if pod > 1:
        raise NotImplementedError(_POD_TIER)
    return map_leaves(params, lambda path, p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device))


def stacked_path(path) -> tuple:
    """The path of the reference's leaf that the port's leaf at ``path`` is
    a slice of: a layer's leaf ``("stack", "segments", si, entry, r, ...)``
    is layer r of the reference's stacked ``("stack", "segments", si,
    entry, ...)``; every other leaf is its own."""
    path = tuple(path)
    if path[:2] == ("stack", "segments") and len(path) > 5:
        return path[:4] + path[5:]
    return path


def _roundtrip(g: torch.Tensor, mode: str,
               absmax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 ``g`` as the wire carries it, decompressed; int8's scale is
    ``absmax`` (default ``max |g|``) / 127."""
    if mode == "bf16":
        return g.to(torch.bfloat16).float()
    if mode == "int8":
        if absmax is None:
            absmax = torch.max(torch.abs(g))
        scale = torch.clamp(absmax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q.float() * scale
    raise ValueError(mode)


@torch.no_grad()
def compress_grads(grads, err_state, mode: str, sharded=None,
                   group=None) -> Tuple[Any, Any]:
    """Returns (the gradients as seen after the wire, in their own dtype,
    the new residuals): per leaf, wire = Q(g + e) and e' = (g + e) - wire,
    with int8's scale shared by the slices of one stacked leaf. ``sharded``
    (a tree of bools like ``grads``) marks the leaves that are one rank's
    shard of a leaf split over ``group``; their int8 scale is the whole
    leaf's."""
    if mode == "none":
        return grads, err_state
    total = map_trees(lambda g, e: g.float() + e, grads, err_state)
    absmax = {}
    if mode == "int8":
        marks = iter(tree_leaves(sharded)) if sharded is not None else None
        split = {}

        def reduce(path, t):
            key = stacked_path(path)
            top = torch.max(torch.abs(t))
            absmax[key] = top if key not in absmax else torch.maximum(absmax[key], top)
            if marks is not None and next(marks):
                split[key] = True
        map_leaves(total, reduce)
        if split and group is not None:
            tops = all_reduce_(torch.stack([absmax[key] for key in split]), group, "max")
            for i, key in enumerate(split):
                absmax[key] = tops[i]
    wires = map_leaves(total, lambda path, t: _roundtrip(t, mode,
                                                         absmax.get(stacked_path(path))))
    return (map_trees(lambda w, g: w.to(g.dtype), wires, grads),
            map_trees(lambda t, w: t - w, total, wires))


def compress_pod_grads(pod_grads, err_state, mode: str):
    """The reference's cross-pod reduction with compressed expert
    gradients; not ported yet."""
    raise NotImplementedError(_POD_TIER)
