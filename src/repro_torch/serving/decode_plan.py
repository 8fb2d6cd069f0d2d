"""Cached decode-shaped CVMM plans and the expert-MLP decode provider
(the reference's ``serving/decode_plan.py``).

Two cache levels:

* skeleton cache: a routing-free ``DecodePlan`` per decode shape class,
  keyed ``(n_tokens, k, n_experts, d_model, expert_size, dtype, device)``.
  A miss builds the static layout and decides its launches' schedules
  (``kernels/ops.py:make_decode_plan``, through the tuner); every later
  call with the same shape reuses it, so at steady state ``rebuilds`` stays
  frozen while ``hits`` climbs.

* assembled cache: the full ``CvmmPlan`` of one (skeleton, routing) pair
  (``ops.assemble_decode_plan``), keyed by the skeleton's shape and the raw
  bytes of (idx, gates). The hot path never touches it
  (``moe_mlp_decode`` runs straight off the skeleton); the plan checker
  and tests use it to hold the decode layout to the plan invariants and to
  show that a routing change makes a new plan.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels import ops as kops


class DecodePlanCache:
    """Skeleton and assembled-plan caches with spy counters: ``rebuilds``
    and ``hits`` count skeleton constructions and reuses, ``assembles`` and
    ``assembled_hits`` the same for plans assembled for a routing."""

    def __init__(self):
        self._skeletons: Dict[Tuple, object] = {}
        self._assembled: Dict[Tuple, object] = {}
        self.rebuilds = 0
        self.hits = 0
        self.assembles = 0
        self.assembled_hits = 0

    def skeleton(self, n_tokens: int, k: int, n_experts: int, device,
                 d_model=None, expert_size=None, dtype=torch.bfloat16):
        """Cached ``DecodePlan`` for one shape class (with its launches'
        schedules when the widths are given)."""
        key = (n_tokens, k, n_experts, d_model, expert_size, str(dtype),
               str(torch.device(device)))
        plan = self._skeletons.get(key)
        if plan is not None:
            self.hits += 1
            return plan
        self.rebuilds += 1
        plan = kops.make_decode_plan(n_tokens, k, n_experts, d_model, expert_size, dtype,
                                     device=device)
        self._skeletons[key] = plan
        return plan

    def assembled(self, plan, idx: torch.Tensor, gates: torch.Tensor):
        """Cached full ``CvmmPlan`` for one routing of ``plan``'s shape."""
        idx_np = idx.detach().cpu().numpy()
        key = (plan.n_tokens, plan.k, plan.n_experts, plan.cap,
               str(plan.tile_expert.device), idx_np.tobytes(),
               gates.detach().float().cpu().numpy().tobytes())
        full = self._assembled.get(key)
        if full is not None:
            self.assembled_hits += 1
            return full
        self.assembles += 1
        full = kops.assemble_decode_plan(plan, idx, gates)
        self._assembled[key] = full
        return full

    def counters(self) -> Dict[str, int]:
        return {"rebuilds": self.rebuilds, "hits": self.hits,
                "assembles": self.assembles, "assembled_hits": self.assembled_hits}


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
        plan = cache.skeleton(n, k, e, xf.device, int(xf.shape[1]),
                              int(cfg.expert_size), xf.dtype)
        w1g = params.get("we1g") if cfg.glu_experts else None
        return kops.moe_mlp_decode(xf, info.idx, info.gates, plan,
                                   params["we1"], params["we2"], w1g,
                                   activation=cfg.activation)

    return provider
