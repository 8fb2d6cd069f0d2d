"""AdamW with float32 master weights (the reference's ``optim/adamw.py``),
leaf for leaf: the same moments, bias corrections and decoupled decay, so
a step matches the reference's. Parameters and moments are updated in
place (the reference returns new trees) to keep one copy of each."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..common import map_trees
from ..configs.base import OptimizerConfig


class OptState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def adamw_init(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(step=0, mu=map_trees(zeros, params),
                    nu=map_trees(zeros, params))


@torch.no_grad()
def adamw_update(grads, state: OptState, params, cfg: OptimizerConfig,
                 lr: float) -> OptState:
    """One AdamW step on ``params`` (updated in place). Returns the new
    optimizer state."""
    step = state.step + 1
    b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step

    def upd(g, m, v, p):
        g = g.float()
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * torch.square(g))
        delta = (m / c1) / (torch.sqrt(v / c2) + eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    map_trees(upd, grads, state.mu, state.nu, params)
    return OptState(step=step, mu=state.mu, nu=state.nu)
