"""Dense and GLU feedforward blocks, the paper's baseline (the reference's
``core/topk_mlp.py``, Sec. 2):

    y = W2 act(W1 x)                       kind "dense"
    y = W2 (act(W1 x) * (W3 x))            kind "glu"

Both are plain large products (the reference's ``jnp.einsum``, outside any
Pallas kernel), so they stay ``torch.matmul``. The "topk" kind (Sec. 3.1)
needs the shared planned aggregation ``dispatch.weighted_value_sum``, which
comes with PKM (ROADMAP queue 1 item 4); until then the registry
(``models/ffn.py``) raises for it.

x: (..., d_model); aux follows the uniform contract (``dispatch.base_aux``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..common import act_fn
from ..configs.base import FFNConfig
from . import init as initlib
from .dispatch import base_aux


def init_dense(gen: torch.Generator, d_model: int, cfg: FFNConfig,
               n_layers: int, dtype=torch.float32, ep_degree: int = 0,
               device="cuda") -> Dict:
    """w1 (d_model, d_ff), w2 (d_ff, d_model) and, for GLU, w3 (d_model,
    d_ff), drawn from ``gen`` in that order with the dense init's stds."""
    del ep_degree                      # uniform registry signature; no EP here
    s1 = initlib.dense_std_in(d_model, n_layers)
    s2 = initlib.dense_std_out(cfg.d_ff, n_layers)
    kw = dict(dtype=dtype, device=device)
    p = {"w1": initlib.normal(gen, (d_model, cfg.d_ff), s1, **kw),
         "w2": initlib.normal(gen, (cfg.d_ff, d_model), s2, **kw)}
    if cfg.kind == "glu":
        p["w3"] = initlib.normal(gen, (d_model, cfg.d_ff), s1, **kw)
    return p


def apply_dense(params: Dict, x: torch.Tensor, cfg: FFNConfig, *,
                gen: Optional[torch.Generator] = None,
                train: bool = False) -> Tuple[torch.Tensor, Dict]:
    """act(x W1) [* x W3] then W2, in x's dtype. No dropout here."""
    del gen, train                     # uniform registry signature
    u = act_fn(cfg.activation)(x @ params["w1"].to(x.dtype))
    if cfg.kind == "glu":
        u = u * (x @ params["w3"].to(x.dtype))
    return u @ params["w2"].to(x.dtype), base_aux(x.device)
