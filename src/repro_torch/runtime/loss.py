"""Cross-entropy with bounded logits memory (the reference's
``runtime/loss.py``): the mean next-token CE over valid positions, either
in one pass or over token chunks whose logits are recomputed in backward
(``torch.utils.checkpoint``), so only one chunk's logits are alive.
Under a mesh the mean is over the global batch's valid positions (its
token count summed over the ranks)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..common import round_up
from ..sharding import all_reduce_sum, current_mesh, pmean


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap else x


def _ce_dense(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor, softcap: float,
              n_valid_vocab: int = 0) -> torch.Tensor:
    """Sum of token CE over valid positions. h (N,D), w (D,V), labels (N,)."""
    logits = _softcap((h @ w).float(), softcap)
    if n_valid_vocab:      # padded vocab: pad columns leave the partition fn
        cols = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(cols < n_valid_vocab, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None].long())[:, 0]
    return torch.sum((lse - gold) * mask)


def chunked_cross_entropy(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                          *, chunks: int = 0, softcap: float = 0.0,
                          mask: Optional[torch.Tensor] = None,
                          n_valid_vocab: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE. h (B,S,D), w (D,V), labels (B,S). Returns
    (mean, n_tok), over the global batch under a mesh."""
    d = h.shape[-1]
    hf = h.reshape(-1, d)
    lf = labels.reshape(-1)
    n = hf.shape[0]
    mf = (mask.reshape(-1).float() if mask is not None
          else torch.ones((n,), dtype=torch.float32, device=h.device))
    if chunks <= 1:
        total = _ce_dense(hf, w, lf, mf, softcap, n_valid_vocab)
    else:
        npad = round_up(n, chunks)
        hf = F.pad(hf, (0, 0, 0, npad - n))
        lf = F.pad(lf, (0, npad - n))
        mf = F.pad(mf, (0, npad - n))
        size = npad // chunks
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(chunks):
            sl = slice(c * size, (c + 1) * size)
            total = total + checkpoint(_ce_dense, hf[sl], w, lf[sl], mf[sl],
                                       softcap, n_valid_vocab,
                                       use_reentrant=False)
    n_tok = torch.sum(mf)
    mesh = current_mesh()
    if mesh is None:
        return total / torch.clamp(n_tok, min=1.0), n_tok
    # R times this rank's share, averaged over the ranks (the gradient
    # convention of sharding/collectives.py)
    group = mesh.group()
    n_tok = all_reduce_sum(n_tok, group)
    return pmean(total * mesh.size / torch.clamp(n_tok, min=1.0), group), n_tok
