"""Map the JAX reference's parameter tree onto the port's parameters.

``from_jax_params(tree, cfg)`` takes the reference's params as nested dicts
and lists of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``)
and returns the port's dict of tensors, path for path. The reference's
``init_stack`` stacks each pattern entry's layers along a leading
``repeats`` axis; the port holds one dict per layer, so those leaves are
un-stacked here, in the decoder's ``stack`` and the encoder's
``enc_stack`` alike. A stack's ``shared`` block (zamba2) is one set of
weights and is carried across as it is. No JAX import: the port never
needs JAX at run time.

``shard_experts(tree, index, shards)`` keeps one rank's slice of the
expert leaves of full parameters (or of their AdamW moments or
compression residuals), for ``dispatch="shard_map"`` on a mesh whose
"model" axis has ``shards`` ranks: every rank draws or converts the full
parameters first, so the initial state equals one process's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .common import map_leaves
from .configs.base import ModelConfig
from .models.stack import plan_segments


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def _stack(stack: Dict, cfg: ModelConfig, n_layers: Optional[int], device) -> Dict:
    out = {}
    if "shared" in stack:
        out["shared"] = map_leaves(stack["shared"], lambda path, a: _tensor(a, device))
    out["segments"] = [
        {name: [map_leaves(entry, lambda path, a, r=r: _tensor(np.asarray(a)[r], device))
                for r in range(seg.repeats)]
         for name, entry in seg_tree.items()}
        for seg, seg_tree in zip(plan_segments(cfg, n_layers), stack["segments"])]
    return out


def from_jax_params(tree: Dict, cfg: ModelConfig, device="cuda") -> Dict:
    """The reference's LM params (numpy leaves) as the port's params."""
    stacks = ("stack", "enc_stack")
    out = map_leaves({k: v for k, v in tree.items() if k not in stacks},
                     lambda path, a: _tensor(a, device))
    out["stack"] = _stack(tree["stack"], cfg, None, device)
    if "enc_stack" in tree:
        out["enc_stack"] = _stack(tree["enc_stack"], cfg, cfg.n_encoder_layers, device)
    return out


# The leaves that ``dispatch="shard_map"`` splits over the "model" axis:
# experts first.
EXPERT_SHARD_NAMES = frozenset({"we1", "we1g", "we2"})


def is_expert_shard(path) -> bool:
    """Whether the leaf at ``path`` is an expert table that expert
    parallelism splits (its last key names one)."""
    name = next((key for key in reversed(path) if isinstance(key, str)), "")
    return name in EXPERT_SHARD_NAMES


def shard_experts(tree, index: int, shards: int):
    """``tree`` with each expert leaf cut to experts [index E/shards,
    (index + 1) E/shards), a copy that requires grad where the leaf did;
    every other leaf as it is. E must divide by ``shards``
    (``build_model(ep_degree=shards)`` pads it)."""
    if shards == 1:
        return tree

    def cut(path, t):
        if not is_expert_shard(path):
            return t
        e = t.shape[0]
        if e % shards:
            raise ValueError(f"{'/'.join(map(str, path))}: {e} experts do not split over "
                             f"{shards} ranks; build the model with ep_degree={shards}")
        part = t.detach()[index * (e // shards):(index + 1) * (e // shards)].clone()
        return part.requires_grad_(t.requires_grad)
    return map_leaves(tree, cut)
