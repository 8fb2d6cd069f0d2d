"""The train and eval steps (the reference's ``runtime/steps.py``, single
device): loss and gradients, optionally accumulated over microbatches,
global-norm clipping, error-feedback gradient compression, the
learning-rate schedule and AdamW, with Transformer-XL memories carried
from step to step (and from microbatch to microbatch); the eval step's
loss without gradients, dropout or memories; and the prefill and decode
wrappers of the serving entry points.

The state is one dict: {"params", "opt", with ``xl_memory`` "mems", and
with compression "err"}. Parameters are float32 master leaves that
require grad; the step updates them in place. The reference's pod tier of
compression needs a device mesh (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..common import map_trees, tree_leaves
from ..configs.base import OptimizerConfig
from ..models.lm import LM
from ..optim import (adamw_init, adamw_update, clip_by_global_norm,
                     compress_grads, init_compression_state, make_schedule)


def init_train_state(model: LM, gen: torch.Generator, opt_cfg: OptimizerConfig,
                     use_mems: bool = False, batch: int = 0,
                     device="cuda") -> Dict[str, Any]:
    """Parameters drawn from ``gen`` on ``device``, zero AdamW moments,
    zero compression residuals when ``opt_cfg.grad_compression`` is on and,
    with ``use_mems``, zero XL memories for ``batch`` rows (with gradient
    accumulation, the rows of one microbatch)."""
    params = model.init(gen, device=device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": adamw_init(params)}
    if opt_cfg.grad_compression != "none":
        state["err"] = init_compression_state(params)
    if use_mems and model.cfg.xl_memory:
        state["mems"] = model.init_mems(batch, device=device)
    return state


def make_train_step(model: LM, opt_cfg: OptimizerConfig, grad_accum: int = 1):
    """Returns ``train_step(state, batch, gen=None) -> (state, metrics)``;
    ``gen`` draws dropout. Metrics are device scalars (no host sync).

    With ``grad_accum`` > 1 the batch's rows split into that many
    microbatches, as the reference's scan does: each runs forward and
    backward on its own, float32 gradients sum divided by ``grad_accum``,
    each microbatch's new XL memories feed the next (so the memories hold
    ``B / grad_accum`` rows, and the next step's first microbatch takes
    the last one's), and the loss and metrics are the microbatches' mean.
    Then clip, compress (``state["err"]``), AdamW, in the reference's
    order."""
    sched = make_schedule(opt_cfg)
    use_mems = bool(model.cfg.xl_memory)

    def grads_of(params, leaves, batch, gen, mems):
        loss, aux = model.loss(params, batch, gen=gen, train=True, mems=mems)
        metrics, new_mems = aux if use_mems else (aux, None)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        for p in leaves:
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, new_mems, grads

    def accumulated(params, leaves, batch, gen, mems):
        rows = batch["tokens"].shape[0]
        if rows % grad_accum:
            raise ValueError(f"the batch's {rows} rows do not split into "
                             f"grad_accum={grad_accum} microbatches")
        mb = rows // grad_accum
        if mems is not None:
            mem_rows = tree_leaves(mems)[0].shape[0]
            if mem_rows != mb:
                raise ValueError(
                    f"XL memories of {mem_rows} rows, but microbatches of {mb} "
                    f"(batch {rows} / grad_accum {grad_accum}): size them for "
                    "one microbatch, as the reference's scan carries them")
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        losses, metricss = [], []
        for i in range(grad_accum):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, metrics, new_mems, grads = grads_of(params, leaves, part, gen, mems)
            for a, g in zip(acc, grads):
                a.add_(g.float() / grad_accum)
            losses.append(loss)
            metricss.append(metrics)
            if use_mems:
                mems = new_mems
        metrics = {k: torch.mean(torch.stack([m[k].float() for m in metricss]))
                   for k in metricss[0]}
        return torch.mean(torch.stack(losses)), metrics, mems, acc

    def train_step(state: Dict[str, Any], batch: Dict,
                   gen: Optional[torch.Generator] = None
                   ) -> Tuple[Dict[str, Any], Dict]:
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        run = grads_of if grad_accum <= 1 else accumulated
        loss, metrics, new_mems, grads = run(params, leaves, batch, gen,
                                             state.get("mems"))
        by_leaf = iter(grads)
        grads = map_trees(lambda p: next(by_leaf), params)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        new_state = dict(state)
        if "err" in state:
            grads, new_state["err"] = compress_grads(grads, state["err"],
                                                     opt_cfg.grad_compression)
        lr = sched(state["opt"].step)
        new_state["opt"] = adamw_update(grads, state["opt"], params, opt_cfg, lr)
        if new_mems is not None:
            new_state["mems"] = new_mems
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
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
