"""FFN registry (the reference's ``models/ffn.py``): wires the paper's
approximators (``core/``) into model blocks.

``FFN_REGISTRY`` maps each kind to one ``FFNEntry(init, apply)`` with a
uniform contract:

    init(gen, d_model, cfg, n_layers, dtype, ep_degree, device) -> params
    apply(params, x, cfg, *, gen, train, collect_stats) -> (y, aux)

where ``aux`` always carries ``moe_reg`` and ``moe_dropped``
(``core/dispatch.base_aux``), so the stack sums aux alike for every kind,
plus ``usage`` (a selection-usage histogram: experts, PKM values or top-K
channels) when ``collect_stats=True``. "dense", "glu", "topk", "pkm",
"none" and "sigma_moe" run; the reference's other MoE kinds are registered
names whose init and apply raise and name their ROADMAP item.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import FFNConfig
from ..core.dispatch import base_aux
from ..core.moe import apply_moe, init_moe
from ..core.pkm import apply_pkm, init_pkm
from ..core.topk_mlp import apply_dense, init_dense

MOE_KINDS = ("sigma_moe", "switch", "sbase", "noisy_topk")


class FFNEntry(NamedTuple):
    """One approximator: paired (init, apply) with the uniform contract."""
    init: Callable[..., Dict]
    apply: Callable[..., Tuple[torch.Tensor, Dict]]


def _init_none(gen, d_model: int, cfg: FFNConfig, n_layers: int,
               dtype=torch.float32, ep_degree: int = 0, device="cuda") -> Dict:
    return {}


def _apply_none(params: Dict, x: torch.Tensor, cfg: FFNConfig, *,
                gen: Optional[torch.Generator] = None, train: bool = False,
                collect_stats: bool = False) -> Tuple[torch.Tensor, Dict]:
    return torch.zeros_like(x), base_aux(x.device)


def _not_ported(item: str) -> FFNEntry:
    def fail(*args, **kwargs):
        cfg = args[2]
        raise NotImplementedError(
            f"ffn kind {cfg.kind!r} is not ported yet (ROADMAP queue 1 {item})")
    return FFNEntry(fail, fail)


FFN_REGISTRY: Dict[str, FFNEntry] = {
    "dense": FFNEntry(init_dense, apply_dense),
    "glu": FFNEntry(init_dense, apply_dense),
    "topk": FFNEntry(init_dense, apply_dense),
    "pkm": FFNEntry(init_pkm, apply_pkm),
    "none": FFNEntry(_init_none, _apply_none),
    "sigma_moe": FFNEntry(init_moe, apply_moe),
    **{kind: _not_ported("item 1, the other MoE kinds and selectors")
       for kind in MOE_KINDS[1:]},
}


def init_ffn(gen: torch.Generator, d_model: int, cfg: FFNConfig,
             n_layers: int, dtype=torch.float32, ep_degree: int = 0,
             device="cuda") -> Dict:
    return FFN_REGISTRY[cfg.kind].init(gen, d_model, cfg, n_layers, dtype,
                                       ep_degree, device)


def apply_ffn(params: Dict, x: torch.Tensor, cfg: FFNConfig, *,
              gen: Optional[torch.Generator] = None, train: bool = False,
              collect_stats: bool = False) -> Tuple[torch.Tensor, Dict]:
    return FFN_REGISTRY[cfg.kind].apply(params, x, cfg, gen=gen, train=train,
                                        collect_stats=collect_stats)
