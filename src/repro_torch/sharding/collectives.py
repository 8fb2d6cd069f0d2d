"""Collectives over a mesh's process groups, as autograd Functions, and the
reductions over the global batch that the model makes through them.

``all_to_all``      ``torch.distributed.all_to_all_single`` in equal
                    chunks along dim 0; its backward is the inverse
                    all_to_all (the same exchange: chunk j of rank i goes
                    to rank j as its chunk i).
``all_reduce_sum``  the sum over the group; its backward is the identity.
``pmean``           the mean over the group; its backward is the identity.
``all_reduce_``     an in-place sum (or max) of a tensor no gradient flows
                    through: counts, squared norms, the train step's
                    gradients.

Without a group (a mesh of one rank started without
``torch.distributed``) each is the identity. ``CALLS`` counts the
collectives issued, per kind, as ``kernels/cvmm.LAUNCHES`` counts kernel
launches.

The gradient convention. Every rank computes the global loss: each
reduction over the batch in it goes through a collective, so its value is
the same on every rank. Each rank backpropagates that loss, and the train
step then all-reduces the gradients and divides them by the rank count R
(``runtime/steps.py``), as data parallelism averages them. So a rank's
backward must give R times its share of the global gradient. A mean over
the ranks whose cotangent is the same everywhere hands each addend 1/R of
it: ``pmean``'s identity backward gives R times that. A sum that a
gradient flows through is written ``R * pmean`` (``batch_sum``).
``all_reduce_sum``'s identity backward gives the addend's share alone (the
reduction out of a parallel region in Megatron-LM), so the port sums with
it only where no gradient flows.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .context import current_mesh

CALLS = {"all_to_all": 0, "all_reduce": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_call_counts() -> None:
    for name in CALLS:
        CALLS[name] = 0


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place ("sum" or "max") and return it;
    the identity without a group. No autograd."""
    if group is not None:
        dist.all_reduce(t, op=_OPS[op], group=group)
        CALLS["all_reduce"] += 1
    return t


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    CALLS["all_to_all"] += 1
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of dim 0 goes to rank j of ``group``; the result holds rank
    i's chunk at position i. Dim 0 must divide by the group's size."""
    return x if group is None else _AllToAll.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduceSum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _PMean.apply(x, group)


def _mesh_group():
    mesh = current_mesh()
    return (None, 1) if mesh is None else (mesh.group(), mesh.size)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over dim 0 of the global batch, of which ``x`` holds this
    rank's rows (every rank holds as many). Differentiable."""
    group, _ = _mesh_group()
    return pmean(torch.mean(x, dim=0), group)


def batch_sum(x: torch.Tensor, dim) -> torch.Tensor:
    """The sum over ``dim`` (the batch's among them) of the global batch.
    Differentiable, as R times a ``pmean`` (see the gradient convention)."""
    group, size = _mesh_group()
    total = torch.sum(x, dim=dim)
    return total if group is None else size * pmean(total, group)


def batch_count(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, where no gradient flows (counts)."""
    group, _ = _mesh_group()
    return all_reduce_sum(x, group)


@torch.no_grad()
def batch_logsumexp(z: torch.Tensor) -> torch.Tensor:
    """logsumexp over dim 0 of the global batch (keepdim), without a
    gradient; on one rank exactly ``torch.logsumexp``'s."""
    lse = torch.logsumexp(z, dim=0, keepdim=True)
    group, _ = _mesh_group()
    if group is None:
        return lse
    top = all_reduce_(lse.clone(), group, "max")
    return top + torch.log(all_reduce_(torch.exp(lse - top), group))
