"""Initialization schemes (paper Sec. 5), as in the reference's
``core/init.py``: experts initialized like the dense baseline they
approximate, with the FULL d_ff. Draws come from an explicit
``torch.Generator``; they do not reproduce JAX's draws (tests convert the
reference's parameters instead)."""
from __future__ import annotations

import math

import torch


def dense_std_in(d_model: int, n_layers: int) -> float:
    return math.sqrt(2.0 / (d_model * max(n_layers, 1)))


def dense_std_out(d_ff: int, n_layers: int) -> float:
    return math.sqrt(2.0 / (d_ff * max(n_layers, 1)))


def normal(gen: torch.Generator, shape, std: float, dtype=torch.float32,
           device="cuda") -> torch.Tensor:
    return std * torch.randn(shape, generator=gen, dtype=dtype, device=device)


def row_normalized(gen: torch.Generator, shape, std: float,
                   dtype=torch.float32, device="cuda") -> torch.Tensor:
    """N(0,1) -> rows rescaled to unit norm -> whole matrix rescaled so the
    elementwise std matches ``std``."""
    w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    w = w / (torch.linalg.norm(w, dim=-1, keepdim=True) + 1e-9)
    return w * (std * math.sqrt(shape[-1]))
