"""Expert selection (the reference's ``core/routing.py``): the softmax and
sigmoid selectors with top-k, expert dropout in training, and PKM's
two-stage product-key top-K. Noisy gating, Sinkhorn and S-BASE are not
ported yet.

``select_experts(logits, cfg) -> SelectionInfo`` with ``gates``/``idx``
(N, K) and the full selection distribution for the regularizers.

Top-k breaks ties toward the lower expert index, as ``jax.lax.top_k`` does:
a stable descending sort, then a slice. ``torch.topk`` promises no order
among equal values, and bf16 softmax scores over 40 experts tie often.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..configs.base import FFNConfig


class SelectionInfo(NamedTuple):
    probs: torch.Tensor     # (N, E) softmax(W3 x)
    sel: torch.Tensor       # (N, E) the selector activation output
    idx: torch.Tensor       # (N, K)
    gates: torch.Tensor     # (N, K)


def top_k(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, ties
    toward the lower index."""
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def norm_topk(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper Eqs. 23-25: keep top-K of s, renormalize to sum 1."""
    vals, idx = top_k(s, k)
    gates = vals / (torch.sum(vals, dim=-1, keepdim=True) + 1e-9)
    return gates, idx


def two_stage_topk(ua: torch.Tensor, ub: torch.Tensor, k: int,
                   n_candidates: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-stage product-key top-K (paper Sec. 3.2): the top-C of each
    sub-key half, then the top-K of the C*C candidate grid va[a] + vb[b],
    which holds the true top-K of the full ns**2 grid when C >= K.

    ua, ub (..., ns). Returns (scores, sel_a, sel_b), each (..., K); the
    value index is ``sel_b * ns + sel_a``. Every top-k here is ``top_k``,
    so ties go toward the lower index as in the reference."""
    c = n_candidates or k
    va, ia = top_k(ua, c)
    vb, ib = top_k(ub, c)
    cand = (va[..., :, None] + vb[..., None, :]).reshape(*va.shape[:-1], c * c)
    top, flat = top_k(cand, k)
    sel_a = torch.gather(ia, -1, flat // c)
    sel_b = torch.gather(ib, -1, flat % c)
    return top, sel_a, sel_b


def expert_dropout_mask(gen: torch.Generator, n_experts: int, rate: float,
                        device="cuda") -> torch.Tensor:
    """Paper Eq. 22: Bernoulli(1 - rate) over whole experts, no rescaling.
    Draws from ``gen``; they differ from JAX's for the same seed."""
    return torch.rand((n_experts,), generator=gen, device=device) < 1.0 - rate


def select_experts(logits: torch.Tensor, cfg: FFNConfig, *,
                   gen: Optional[torch.Generator] = None, train: bool = False,
                   n_valid_experts: Optional[int] = None) -> SelectionInfo:
    """logits (N, E_padded) = x @ W3; experts at or past ``n_valid_experts``
    are padding and masked out. In training with a generator and
    ``cfg.expert_dropout`` > 0, whole experts are dropped from ``sel``."""
    n, e = logits.shape
    k = cfg.k
    if n_valid_experts is not None and n_valid_experts < e:
        valid = torch.arange(e, device=logits.device) < n_valid_experts
        logits = torch.where(valid[None, :], logits,
                             torch.full_like(logits, -1e9))
    probs = torch.softmax(logits, dim=-1)

    act = cfg.selector_activation
    if act == "sigmoid":
        sel = torch.sigmoid(logits)
    elif act in ("softmax", "softmax_pre_topk"):
        sel = probs
    else:
        raise ValueError(f"unknown selector activation {act}")

    if train and cfg.expert_dropout > 0.0 and gen is not None:
        mask = expert_dropout_mask(gen, e, cfg.expert_dropout, logits.device)
        sel = sel * mask[None, :].to(sel.dtype)

    if act == "softmax_pre_topk" or (act == "softmax" and cfg.renormalize):
        gates, idx = norm_topk(sel, k)
    else:
        gates, idx = top_k(sel, k)
        if cfg.renormalize:
            gates = gates / (torch.sum(gates, dim=-1, keepdim=True) + 1e-9)
    return SelectionInfo(probs=probs, sel=sel, idx=idx, gates=gates)
