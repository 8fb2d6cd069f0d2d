"""FFN entry of a block (the reference's ``models/ffn.py``): the port
runs sigma-MoE; the other kinds come with their slices."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import FFNConfig
from ..core.moe import apply_moe, init_moe


def _check(cfg: FFNConfig) -> None:
    if cfg.kind != "sigma_moe":
        raise NotImplementedError(f"ffn kind {cfg.kind!r} is not ported yet")


def init_ffn(gen: torch.Generator, d_model: int, cfg: FFNConfig,
             n_layers: int, dtype=torch.float32, ep_degree: int = 0,
             device="cuda") -> Dict:
    _check(cfg)
    return init_moe(gen, d_model, cfg, n_layers, dtype, ep_degree, device)


def apply_ffn(params: Dict, x: torch.Tensor, cfg: FFNConfig, *,
              gen: Optional[torch.Generator] = None,
              train: bool = False) -> Tuple[torch.Tensor, Dict]:
    _check(cfg)
    return apply_moe(params, x, cfg, gen=gen, train=train)
