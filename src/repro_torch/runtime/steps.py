"""The train and eval steps (the reference's ``runtime/steps.py``, single
device): loss and gradients, global-norm clipping, the learning-rate
schedule and AdamW, with Transformer-XL memories carried from step to step;
the eval step's loss without gradients, dropout or memories; and the
prefill and decode wrappers of the serving entry points.

The state is one dict: {"params", "opt", and with ``xl_memory`` "mems"}.
Parameters are float32 master leaves that require grad; the step updates
them in place. Gradient accumulation, gradient compression and the pod
tier of the reference are not ported yet (ROADMAP queue 1 items 1 and 8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..common import map_trees, tree_leaves
from ..configs.base import OptimizerConfig
from ..models.lm import LM
from ..optim import adamw_init, adamw_update, clip_by_global_norm, make_schedule


def init_train_state(model: LM, gen: torch.Generator, opt_cfg: OptimizerConfig,
                     use_mems: bool = False, batch: int = 0,
                     device="cuda") -> Dict[str, Any]:
    """Parameters drawn from ``gen`` on ``device``, zero AdamW moments and,
    with ``use_mems``, zero XL memories for ``batch`` rows."""
    params = model.init(gen, device=device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": adamw_init(params)}
    if use_mems and model.cfg.xl_memory:
        state["mems"] = model.init_mems(batch, device=device)
    return state


def make_train_step(model: LM, opt_cfg: OptimizerConfig):
    """Returns ``train_step(state, batch, gen=None) -> (state, metrics)``;
    ``gen`` draws dropout. Metrics are device scalars (no host sync)."""
    if opt_cfg.grad_accum != 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    if opt_cfg.grad_compression != "none":
        raise NotImplementedError("gradient compression is not ported yet")
    sched = make_schedule(opt_cfg)
    use_mems = bool(model.cfg.xl_memory)

    def train_step(state: Dict[str, Any], batch: Dict,
                   gen: Optional[torch.Generator] = None
                   ) -> Tuple[Dict[str, Any], Dict]:
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        loss, aux = model.loss(params, batch, gen=gen, train=True,
                               mems=state.get("mems"))
        metrics, new_mems = aux if use_mems else (aux, None)
        loss.backward()
        grads = map_trees(lambda p: p.grad if p.grad is not None
                          else torch.zeros_like(p), params)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        lr = sched(state["opt"].step)
        new_state = dict(state, opt=adamw_update(grads, state["opt"], params,
                                                 opt_cfg, lr))
        for p in leaves:
            p.grad = None
        if new_mems is not None:
            new_state["mems"] = new_mems
        metrics = dict(metrics, loss=loss.detach(), grad_norm=gnorm, lr=lr)
        return new_state, metrics

    return train_step


def make_eval_step(model: LM):
    """Returns ``eval_step(params, batch) -> (loss, metrics)``: the loss in
    inference mode (no dropout, no XL memories), without gradients."""
    def eval_step(params, batch):
        with torch.no_grad():
            return model.loss(params, batch, gen=None, train=False)
    return eval_step


def make_prefill_step(model: LM, max_len: int):
    """``LM.prefill`` under the reference's step name (``max_len`` is its
    signature's, unused there too)."""
    def prefill_step(params, tokens, cache):
        return model.prefill(params, tokens, cache)
    return prefill_step


def make_decode_step(model: LM):
    """``LM.decode_step`` under the reference's step name."""
    def decode_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)
    return decode_step
