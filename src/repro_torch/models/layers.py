"""Common layers (the reference's ``models/layers.py``): norms,
embeddings, dropout, learned, sinusoidal and rotary position embeddings."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..sharding import global_draw


def init_norm(cfg: ModelConfig, d: int, dtype=torch.float32,
              device="cuda") -> Dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Computed in float32, returned in x's dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * params["scale"].float()
    return y.to(x.dtype)


def rms_norm_simple(x: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, dtype=dtype,
                       device=device) * (d ** -0.5)


def learned_positions(table: torch.Tensor, pos_offset: int, n: int,
                      dtype) -> torch.Tensor:
    """Rows [pos_offset, pos_offset + n) of a learned position table
    (max_len, d) in ``dtype``: whisper's decoder positions, offset by the
    tokens already in the cache at decode."""
    if not 0 <= pos_offset <= table.shape[0] - n:
        raise ValueError(f"positions {pos_offset}..{pos_offset + n - 1} outside the "
                         f"learned table of {table.shape[0]}")
    return table[pos_offset:pos_offset + n].to(dtype)


def dropout(gen: Optional[torch.Generator], x: torch.Tensor, rate: float,
            train: bool) -> torch.Tensor:
    """Inverted dropout with draws from ``gen``; the identity outside
    training, at rate 0, or without a generator (as the reference without
    an rng). The draws differ from JAX's for the same seed. Under a mesh
    the mask is drawn for the global batch and this rank's rows kept
    (``sharding.global_draw``)."""
    if not train or rate <= 0.0 or gen is None:
        return x
    keep = global_draw(lambda shape: torch.rand(shape, generator=gen, device=x.device),
                       x.shape) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def sinusoid_positions(n: int, d: int, dtype=torch.float32,
                       device="cuda") -> torch.Tensor:
    """Classic sinusoidal table (n, d): sines then cosines, as the reference
    (used by XL relative encodings)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=device) / d))
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) or (S,). The half-split form,
    computed in float32, as in the reference (not the interleaved form)."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions.float()[..., None] * freqs                # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
