"""Product-key memories (the reference's ``core/pkm.py``; paper Sec. 3.2,
App. A.3; Lample et al. 2019), with the paper's changes: no batch norm, the
input split into two halves with no query projection, ReLU (or the
softmax ablation) over the selected scores, and optionally the paper's
dense-equivalent init.

A PKM is an expert_size-1 MoE over ``n_values = n_subkeys**2`` value rows.
``pkm_select`` is the selection rule: per head, the sub-key scores of each
half, the two-stage top-K of their sums (``routing.two_stage_topk``: top-C
of each half, then top-K of the C*C grid, exact for C >= K), so the full
(N, ns**2) score matrix never exists. The weighted sum of the selected
values is the shared ``dispatch.weighted_value_sum``, which runs K6 on
CUDA; ``impl="dense"`` keeps the (N, H*K, d) gather and einsum as the
oracle (``_aggregate_dense``), on the CPU only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import FFNConfig
from . import init as initlib
from . import routing
from .dispatch import (Selection, base_aux, selection_usage, value_sum_path,
                       weighted_value_sum)


def init_pkm(gen: torch.Generator, d_model: int, cfg: FFNConfig,
             n_layers: int, dtype=torch.float32, ep_degree: int = 0,
             device="cuda") -> Dict:
    """keys_a, keys_b (heads, d_model/2, n_subkeys) and values (n_values,
    d_model), drawn from ``gen`` in that order."""
    del ep_degree                      # uniform registry signature; no EP here
    h, ns = cfg.pkm_heads, cfg.n_subkeys
    half = d_model // 2
    if cfg.sigma_moe_init:
        s_k = initlib.dense_std_in(d_model, n_layers)
        s_v = initlib.dense_std_out(cfg.n_values, n_layers)
    else:
        s_k = d_model ** -0.5
        s_v = cfg.n_values ** -0.5
    kw = dict(dtype=dtype, device=device)
    return {"keys_a": initlib.normal(gen, (h, half, ns), s_k, **kw),
            "keys_b": initlib.normal(gen, (h, half, ns), s_k, **kw),
            "values": initlib.normal(gen, (cfg.n_values, d_model), s_v, **kw)}


def _sub_key_scores(params: Dict, xf: torch.Tensor, dtype):
    """(ua, ub), each (N, H, ns): the two halves of x against their keys."""
    xa, xb = torch.chunk(xf, 2, dim=-1)
    ua = torch.einsum("nd,hds->nhs", xa, params["keys_a"].to(dtype))
    ub = torch.einsum("nd,hds->nhs", xb, params["keys_b"].to(dtype))
    return ua, ub


def pkm_select(params: Dict, xf: torch.Tensor, cfg: FFNConfig) -> Selection:
    """Product-key retrieval: a Selection over the ns**2 value rows with
    S = H * K slots a token (idx and weights (N, H*K))."""
    h, ns, knn = cfg.pkm_heads, cfg.n_subkeys, cfg.pkm_knn
    ua, ub = _sub_key_scores(params, xf, xf.dtype)
    top, sel_a, sel_b = routing.two_stage_topk(ua, ub, knn, cfg.pkm_candidates)
    vidx = sel_b * ns + sel_a            # u[i] = ub[i // ns] + ua[i % ns] (Eq. 8)
    if cfg.activation == "softmax":
        w = torch.softmax(top, dim=-1)
    else:                                # relu, the paper's choice
        w = torch.relu(top)
    n = xf.shape[0]
    return Selection(idx=vidx.reshape(n, h * knn), weights=w.reshape(n, h * knn),
                     n_items=cfg.n_values)


def _aggregate_dense(values: torch.Tensor, sel: Selection) -> torch.Tensor:
    """impl="dense" oracle: the (N, S, d) gather and einsum."""
    vals = values[sel.idx]
    return torch.einsum("ns,nsd->nd", sel.weights.to(vals.dtype), vals)


def apply_pkm(params: Dict, x: torch.Tensor, cfg: FFNConfig, *,
              gen: Optional[torch.Generator] = None, train: bool = False,
              collect_stats: bool = False) -> Tuple[torch.Tensor, Dict]:
    """PKM FFN in x's dtype. With ``collect_stats``, ``aux["usage"]`` is the
    value-usage histogram (``dispatch.selection_usage``)."""
    del gen, train                     # uniform registry signature; PKM is static
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d)
    sel = pkm_select(params, xf, cfg)
    values = params["values"].to(x.dtype)
    if value_sum_path(cfg, d, values.dtype, x.device) == "dense":
        y = _aggregate_dense(values, sel)
    else:
        y = weighted_value_sum(values, sel, xf.shape[0], cfg)
    aux = base_aux(x.device)
    if collect_stats:
        aux["usage"] = selection_usage(sel)
    return y.reshape(*lead, d), aux


def pkm_full_scores(params: Dict, x: torch.Tensor, cfg: FFNConfig) -> torch.Tensor:
    """Oracle: the full score grid (N, H, ns*ns), u[i] = ub[i // ns] +
    ua[i % ns]; for tests only."""
    ua, ub = _sub_key_scores(params, x.reshape(-1, x.shape[-1]),
                             params["keys_a"].dtype)
    ns = cfg.n_subkeys
    return (ub[..., :, None] + ua[..., None, :]).reshape(*ua.shape[:-1], ns * ns)
