"""The train and eval steps (the reference's ``runtime/steps.py``): loss
and gradients, optionally accumulated over microbatches, global-norm
clipping, error-feedback gradient compression, the learning-rate schedule
and AdamW, with Transformer-XL memories carried from step to step (and
from microbatch to microbatch); the eval step's loss without gradients,
dropout or memories; and the prefill and decode wrappers of the serving
entry points.

The state is one dict: {"params", "opt", with ``xl_memory`` "mems", and
with compression "err"}. Parameters are float32 master leaves that
require grad; the step updates them in place.

On a mesh (``make_train_step(mesh=)``, one rank a process) a rank takes
its rows of the global batch, computes the global loss (the model's batch
reductions go through collectives) and its gradients, and all-reduces
them divided by the rank count: replicated leaves over the whole mesh,
expert shards (``dispatch="shard_map"``) over every axis but "model",
whose all_to_all's backward has summed them over "model" already. Then
clip, compress and AdamW, as on one device, so the step is one process's
on the global batch. The reference's pod tier (a 'pod' axis of more than
one with compression: per-pod partial gradients, compressed in the
cross-pod reduction) is not ported and raises; neither is the capacity
dispatch on more than one rank (ROADMAP.md, queue 1 item 8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..common import map_leaves, map_trees, tree_leaves
from ..configs.base import OptimizerConfig
from ..convert import is_expert_shard, shard_experts
from ..core.dispatch import expert_shards
from ..models.lm import LM
from ..optim import (adamw_init, adamw_update, clip_by_global_norm, compress,
                     compress_grads, init_compression_state, make_schedule)
from ..sharding import Mesh, all_reduce_, mesh_context


def init_train_state(model: LM, gen: torch.Generator, opt_cfg: OptimizerConfig,
                     use_mems: bool = False, batch: int = 0,
                     device="cuda", mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """Parameters drawn from ``gen`` on ``device``, zero AdamW moments,
    zero compression residuals when ``opt_cfg.grad_compression`` is on and,
    with ``use_mems``, zero XL memories for ``batch`` rows (with gradient
    accumulation, the rows of one microbatch; on a mesh, this rank's share
    of them). On a mesh that shards the experts every rank draws the full
    parameters and keeps its shard (``convert.shard_experts``)."""
    params = model.init(gen, device=device)
    if mesh is not None:
        params = shard_experts(params, mesh.coords.get("model", 0),
                               expert_shards(model.cfg.ffn, mesh))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": adamw_init(params)}
    if opt_cfg.grad_compression != "none":
        state["err"] = init_compression_state(params)
    if use_mems and model.cfg.xl_memory:
        state["mems"] = model.init_mems(batch, device=device)
    return state


def _reduce_grads(grads: list, sharded: list, mesh: Mesh) -> list:
    """Every gradient summed over the ranks that hold the same leaf (the
    whole mesh; for an expert shard every axis but "model") and divided by
    the rank count; one all-reduce per group, on a flat buffer."""
    out = list(grads)
    others = tuple(a for a in mesh.axis_names if a != "model")
    for shard in (False, True):
        group = (mesh.group(*others) if others else None) if shard else mesh.group()
        picked = [i for i, s in enumerate(sharded) if s == shard]
        if group is None or not picked:
            continue
        flat = torch.cat([grads[i].reshape(-1) for i in picked])
        all_reduce_(flat, group).div_(mesh.size)
        for i, part in zip(picked, flat.split([grads[i].numel() for i in picked])):
            out[i] = part.view_as(grads[i])
    return out


def make_train_step(model: LM, opt_cfg: OptimizerConfig, grad_accum: int = 1,
                    mesh: Optional[Mesh] = None):
    """Returns ``train_step(state, batch, gen=None) -> (state, metrics)``;
    ``gen`` draws dropout. Metrics are device scalars (no host sync).

    With ``grad_accum`` > 1 the batch's rows split into that many
    microbatches, as the reference's scan does: each runs forward and
    backward on its own, float32 gradients sum divided by ``grad_accum``,
    each microbatch's new XL memories feed the next (so the memories hold
    ``B / grad_accum`` rows, and the next step's first microbatch takes
    the last one's), and the loss and metrics are the microbatches' mean.
    Then clip, compress (``state["err"]``), AdamW, in the reference's
    order.

    With ``mesh`` the step runs under it (``mesh_context``): ``batch`` is
    the global batch, of which this rank takes its share of each
    microbatch (``Mesh.local_rows``), and the gradients are all-reduced
    before the clip (see the module docstring). Its XL memories hold this
    rank's rows; ``gen`` must be seeded alike on every rank."""
    sched = make_schedule(opt_cfg)
    use_mems = bool(model.cfg.xl_memory)
    if mesh is not None and mesh.shape.get("pod", 1) > 1:
        raise NotImplementedError(compress._POD_TIER)
    shards = expert_shards(model.cfg.ffn, mesh) if mesh is not None else 1

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
        if mesh is None:
            return step_on(state, batch, gen)
        with mesh_context(mesh):
            return step_on(state, {k: mesh.local_rows(v, grad_accum)
                                   for k, v in batch.items()}, gen)

    def step_on(state, batch, gen):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        run = grads_of if grad_accum <= 1 else accumulated
        loss, metrics, new_mems, grads = run(params, leaves, batch, gen,
                                             state.get("mems"))
        sharded, group = None, None
        if mesh is not None:
            sharded = map_leaves(params, lambda path, p: shards > 1 and is_expert_shard(path))
            grads = _reduce_grads(grads, tree_leaves(sharded), mesh)
            group = mesh.group("model")
        by_leaf = iter(grads)
        grads = map_trees(lambda p: next(by_leaf), params)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip, sharded, group)
        new_state = dict(state)
        if "err" in state:
            grads, new_state["err"] = compress_grads(grads, state["err"],
                                                     opt_cfg.grad_compression, sharded,
                                                     group)
        lr = sched(state["opt"].step)
        new_state["opt"] = adamw_update(grads, state["opt"], params, opt_cfg, lr)
        if new_mems is not None:
            new_state["mems"] = new_mems
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return new_state, metrics

    return train_step


def make_eval_step(model: LM, mesh: Optional[Mesh] = None):
    """Returns ``eval_step(params, batch) -> (loss, metrics)``: the loss in
    inference mode (no dropout, no XL memories), without gradients; with
    ``mesh``, of the global ``batch``, each rank on its rows."""
    def eval_step(params, batch):
        with torch.no_grad():
            if mesh is None:
                return model.loss(params, batch, gen=None, train=False)
            with mesh_context(mesh):
                return model.loss(params, {k: mesh.local_rows(v) for k, v in batch.items()},
                                  gen=None, train=False)
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
