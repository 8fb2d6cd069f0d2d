"""Load-balancing regularizers (paper Sec. 4-5), as in the reference's
``core/regularizers.py``: each maps a layer's SelectionInfo to a scalar
loss (already sign-correct for minimization). ``usage_stats`` is the
expert-usage diagnostic of ``apply_moe(collect_stats=True)``.

Each reduces over the global batch: under a mesh a rank holds its own
tokens' routing, and its batch means and sums go through collectives over
the whole mesh (``sharding.batch_mean``, ``batch_sum``, ``batch_count``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding import batch_count, batch_mean, batch_sum
from .routing import SelectionInfo


def entropy_reg(info: SelectionInfo, n_valid: int) -> torch.Tensor:
    """sigma-MoE (Eqs. 20-21): L = sum_e p[e] log p[e], p = batch-mean softmax."""
    p = batch_mean(info.probs.float())[:n_valid]
    return torch.sum(p * torch.log(p + 1e-9))


def switch_reg(info: SelectionInfo, n_valid: int) -> torch.Tensor:
    """Switch Transformer (Eqs. 15-17): L = N_E * f . p with hard fraction f."""
    e = info.probs.shape[1]
    k = info.idx.shape[-1]
    onehot = F.one_hot(info.idx.long(), e).float()             # (N, K, E)
    f = batch_mean(torch.sum(onehot, dim=1))                   # (E,)
    p = batch_mean(info.probs.float())
    return n_valid * torch.sum((f * p)[:n_valid]) / k


def cv_reg(info: SelectionInfo, n_valid: int) -> torch.Tensor:
    """Sparsely-Gated MoE (Eq. 14): CV^2 of total normalized-top-K importance."""
    e = info.probs.shape[1]
    onehot = F.one_hot(info.idx.long(), e).float()
    imp = batch_sum(onehot * info.gates.float()[..., None], dim=(0, 1))[:n_valid]
    return torch.var(imp, unbiased=False) / (torch.mean(imp) ** 2 + 1e-9)


REGULARIZERS = {"entropy": entropy_reg, "switch": switch_reg, "cv": cv_reg,
                "none": lambda info, n_valid: torch.zeros(
                    (), device=info.probs.device)}


def usage_stats(info: SelectionInfo, n_valid: int):
    """Diagnostics for expert-collapse analysis (paper Fig. 3/7): selection
    counts and summed gates per valid expert, and the counts' entropy."""
    e = info.probs.shape[1]
    onehot = F.one_hot(info.idx.long(), e).float()
    counts = batch_count(torch.sum(onehot, dim=(0, 1)))[:n_valid]
    weight = batch_count(torch.sum(onehot * info.gates.float()[..., None],
                                   dim=(0, 1)))[:n_valid]
    frac = counts / (torch.sum(counts) + 1e-9)
    ent = -torch.sum(frac * torch.log(frac + 1e-9))
    return {"counts": counts, "weight": weight, "usage_entropy": ent}
