"""Map the JAX reference's parameter tree onto the port's parameters.

``from_jax_params(tree, cfg)`` takes the reference's params as nested dicts
and lists of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``)
and returns the port's dict of tensors, path for path. The reference's
``init_stack`` stacks each pattern entry's layers along a leading
``repeats`` axis; the port holds one dict per layer, so those leaves are
un-stacked here. No JAX import: the port never needs JAX at run time.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .common import map_leaves
from .configs.base import ModelConfig
from .models.stack import plan_segments


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def from_jax_params(tree: Dict, cfg: ModelConfig, device="cuda") -> Dict:
    """The reference's LM params (numpy leaves) as the port's params."""
    out = map_leaves({k: v for k, v in tree.items() if k != "stack"},
                     lambda path, a: _tensor(a, device))
    segs = plan_segments(cfg)
    stack = tree["stack"]
    if set(stack) != {"segments"}:
        raise NotImplementedError("shared blocks are not ported yet")
    out["stack"] = {"segments": []}
    for seg, seg_tree in zip(segs, stack["segments"]):
        out["stack"]["segments"].append({
            name: [map_leaves(entry, lambda path, a, r=r: _tensor(
                       np.asarray(a)[r], device)) for r in range(seg.repeats)]
            for name, entry in seg_tree.items()})
    return out
