"""Pure-torch oracles for the CVMM (conditional vector-matrix multiply)
kernels, as in the reference's ``kernels/ref.py``.

CVMM(V, S, W)[n] = V[n] @ W[S[n]] on rows sorted by expert, with
``group_sizes`` (E,) summing to the row count.
"""
from __future__ import annotations

import torch


def row_experts(group_sizes: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Expert id of each sorted row: row i belongs to the group whose
    cumulative range contains i."""
    ends = torch.cumsum(group_sizes, 0)
    rows = torch.arange(n_rows, device=group_sizes.device, dtype=ends.dtype)
    return torch.searchsorted(ends, rows, right=True)


def cvmm_ref(x: torch.Tensor, group_sizes: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """(N, K) x (E,) x (E, K, L) -> (N, L); float32 accumulation."""
    e = w.shape[0]
    re = row_experts(group_sizes, x.shape[0])
    onehot = torch.nn.functional.one_hot(re, e).float()
    out = torch.einsum("nk,ekl,ne->nl", x.float(), w.float(), onehot)
    return out.to(x.dtype)
