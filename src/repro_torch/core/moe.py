"""sigma-MoE parameters and routing (the reference's ``core/moe.py``):
expert and selector initialization (paper Sec. 5), the routing front-end,
shared always-on experts and the regularizer bookkeeping. Execution lives
in core/dispatch.py (``expert_mlp``)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..common import act_fn, round_up
from ..configs.base import FFNConfig
from . import init as initlib
from .dispatch import expert_mlp
from .regularizers import REGULARIZERS, usage_stats
from .routing import SelectionInfo, select_experts


def n_experts_padded(cfg: FFNConfig, ep_degree: int = 0) -> int:
    if ep_degree and cfg.n_experts % ep_degree:
        return round_up(cfg.n_experts, ep_degree)
    return cfg.n_experts


def init_moe(gen: torch.Generator, d_model: int, cfg: FFNConfig,
             n_layers: int, dtype=torch.float32, ep_degree: int = 0,
             device="cuda") -> Dict:
    """Expert + selector parameters, in the reference's layout:
    we1/we1g (E, d, G), we2 (E, G, d), router (d, E)."""
    e = n_experts_padded(cfg, ep_degree)
    g = cfg.expert_size
    d_ff = cfg.n_experts * g
    if cfg.sigma_moe_init:
        s1 = initlib.dense_std_in(d_model, n_layers)
        s2 = initlib.dense_std_out(d_ff, n_layers)
    else:
        s1 = d_model ** -0.5
        s2 = (0.1 / g) ** 0.5
    kw = dict(dtype=dtype, device=device)
    p = {
        "we1": initlib.normal(gen, (e, d_model, g), s1, **kw),
        "we2": initlib.normal(gen, (e, g, d_model), s2, **kw),
        "router": (initlib.row_normalized(gen, (cfg.n_experts, d_model), s1,
                                          **kw).T.contiguous()
                   if cfg.sigma_moe_init else
                   initlib.normal(gen, (d_model, cfg.n_experts), s1, **kw)),
    }
    if cfg.glu_experts:
        p["we1g"] = initlib.normal(gen, (e, d_model, g), s1, **kw)
    if cfg.n_shared_experts:
        se = cfg.n_shared_experts
        p["shared_w1"] = initlib.normal(gen, (se, d_model, g), s1, **kw)
        p["shared_w2"] = initlib.normal(gen, (se, g, d_model), s2, **kw)
        if cfg.glu_experts:
            p["shared_w1g"] = initlib.normal(gen, (se, d_model, g), s1, **kw)
    return p


def _route(params: Dict, xf: torch.Tensor, cfg: FFNConfig, e_pad: int,
           gen: Optional[torch.Generator], train: bool) -> SelectionInfo:
    logits = xf @ params["router"].to(xf.dtype)
    if e_pad > cfg.n_experts:
        pad = logits.new_full((xf.shape[0], e_pad - cfg.n_experts), -1e9)
        logits = torch.cat([logits, pad], dim=-1)
    return select_experts(logits, cfg, gen=gen, train=train,
                          n_valid_experts=cfg.n_experts)


def apply_moe(params: Dict, x: torch.Tensor, cfg: FFNConfig, *,
              gen: Optional[torch.Generator] = None, train: bool = False,
              collect_stats: bool = False) -> Tuple[torch.Tensor, Dict]:
    """y_hat = sum_{e in E_x} W2^e s[e] act(W1^e x)  (paper Eq. 11) + aux.
    ``aux["moe_reg"]`` is the scaled regularizer, differentiable through the
    router; ``gen`` draws the expert dropout mask in training; with
    ``collect_stats``, ``aux["usage"]`` is ``usage_stats`` of the routing."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    e = params["we1"].shape[0]
    info = _route(params, xf, cfg, e, gen, train)
    y, dropped = expert_mlp(params, xf, cfg, info, e)
    if cfg.n_shared_experts:
        hs = torch.einsum("nd,edg->eng", xf, params["shared_w1"].to(xf.dtype))
        us = act_fn(cfg.activation)(hs)
        if cfg.glu_experts:
            us = us * torch.einsum("nd,edg->eng", xf,
                                   params["shared_w1g"].to(xf.dtype))
        y = y + torch.einsum("eng,egd->nd", us, params["shared_w2"].to(xf.dtype))
    reg = REGULARIZERS[cfg.reg_kind](info, cfg.n_experts)
    aux = {"moe_reg": cfg.reg_gamma * reg, "moe_dropped": dropped}
    if collect_stats:
        aux["usage"] = usage_stats(info, cfg.n_experts)
    return y.reshape(*lead, d), aux
