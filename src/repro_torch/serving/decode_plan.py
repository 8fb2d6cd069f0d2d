"""Cached decode-shaped CVMM plans and the expert-MLP decode provider
(the reference's ``serving/decode_plan.py``).

The skeleton cache maps ``(n_tokens, k, n_experts, device)`` to a
routing-free ``DecodePlan`` (``kernels/ops.py:make_decode_plan``). Every
later call with the same shape reuses it, so at steady state ``rebuilds`` stays frozen while ``hits``
climbs. The reference's second level, full ``CvmmPlan``s assembled per
routing for its plan checker and bench, is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels import ops as kops


class DecodePlanCache:
    """Skeleton cache with spy counters: ``rebuilds`` counts constructions,
    ``hits`` reuses."""

    def __init__(self):
        self._skeletons: Dict[Tuple, object] = {}
        self.rebuilds = 0
        self.hits = 0

    def skeleton(self, n_tokens: int, k: int, n_experts: int, device):
        """Cached ``DecodePlan`` for one shape class."""
        key = (n_tokens, k, n_experts, str(torch.device(device)))
        plan = self._skeletons.get(key)
        if plan is not None:
            self.hits += 1
            return plan
        self.rebuilds += 1
        plan = kops.make_decode_plan(n_tokens, k, n_experts, device=device)
        self._skeletons[key] = plan
        return plan

    def counters(self) -> Dict[str, int]:
        return {"rebuilds": self.rebuilds, "hits": self.hits}


def make_provider(cache: DecodePlanCache, *, max_tokens: int = 64):
    """An ``expert_mlp`` decode provider backed by ``cache``: it serves the
    sort dispatch for calls of at most ``max_tokens`` tokens and returns
    None (declines) for anything larger. Install with
    ``core.dispatch.set_decode_provider``; remove with ``None``."""

    def provider(params, xf, cfg, info, e):
        n = int(xf.shape[0])
        if n > max_tokens:
            return None
        k = int(info.idx.shape[-1])
        plan = cache.skeleton(n, k, e, xf.device)
        w1g = params.get("we1g") if cfg.glu_experts else None
        return kops.moe_mlp_decode(xf, info.idx, info.gates, plan,
                                   params["we1"], params["we2"], w1g,
                                   activation=cfg.activation)

    return provider
