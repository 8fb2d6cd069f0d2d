"""Dense, GLU and top-K-activation feedforward blocks (the reference's
``core/topk_mlp.py``, paper Sec. 2 and 3.1):

    y = W2 act(W1 x)                       kind "dense"
    y = W2 (act(W1 x) * (W3 x))            kind "glu"
    y = W2 topK(act(W1 x))                 kind "topk"

Dense and GLU are plain large products (the reference's ``jnp.einsum``,
outside any Pallas kernel), so they stay ``torch.matmul``. The top-K
activation is the framework's simplest selection rule: ``routing.top_k``
over u = act(W1 x) picks K of the d_ff rows of W2, and the down-projection
is the shared weighted value sum (``dispatch.weighted_value_sum``, W2 the
value table, the K surviving activations the weights), which runs K6 on
CUDA. The full up-projection is still needed to find the top-K (Sec.
3.1), so only the down-projection is sparse. ``impl="dense"`` keeps the
masked dense down-projection as the oracle (``_down_dense``), on the CPU
only.

x: (..., d_model); aux follows the uniform contract (``dispatch.base_aux``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..common import act_fn
from ..configs.base import FFNConfig
from . import init as initlib
from . import routing
from .dispatch import (Selection, base_aux, selection_usage, value_sum_path,
                       weighted_value_sum)


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


def _down_dense(u: torch.Tensor, w2: torch.Tensor, k: int) -> torch.Tensor:
    """impl="dense" oracle: the top-K mask (Eq. 6-7) and the full
    down-projection. With ReLU u >= 0, so keeping u >= the K-th largest
    value gives the sparse path's sum."""
    kth = routing.top_k(u, k)[0][..., -1:]
    return u.masked_fill(u < kth, 0) @ w2


def apply_dense(params: Dict, x: torch.Tensor, cfg: FFNConfig, *,
                gen: Optional[torch.Generator] = None, train: bool = False,
                collect_stats: bool = False) -> Tuple[torch.Tensor, Dict]:
    """dense | glu | topk in x's dtype; no dropout here. With
    ``collect_stats``, the top-K kind's ``aux["usage"]`` is the usage of
    the d_ff channels (``dispatch.selection_usage``)."""
    del gen, train                     # uniform registry signature
    aux = base_aux(x.device)
    u = act_fn(cfg.activation)(x @ params["w1"].to(x.dtype))
    if cfg.kind == "glu":
        u = u * (x @ params["w3"].to(x.dtype))
    w2 = params["w2"].to(x.dtype)
    if cfg.kind == "topk" and cfg.topk_k and cfg.topk_k < cfg.d_ff:
        lead = x.shape[:-1]
        uf = u.reshape(-1, cfg.d_ff)
        if value_sum_path(cfg, w2.shape[-1], w2.dtype, x.device) == "dense":
            y = _down_dense(uf, w2, cfg.topk_k)
            if collect_stats:
                vals, idx = routing.top_k(uf, cfg.topk_k)
                aux["usage"] = selection_usage(
                    Selection(idx=idx, weights=vals, n_items=cfg.d_ff))
            return y.reshape(*lead, -1), aux
        vals, idx = routing.top_k(uf, cfg.topk_k)
        sel = Selection(idx=idx, weights=vals, n_items=cfg.d_ff)
        y = weighted_value_sum(w2, sel, uf.shape[0], cfg)
        if collect_stats:
            aux["usage"] = selection_usage(sel)
        return y.reshape(*lead, -1), aux
    return u @ w2, aux
