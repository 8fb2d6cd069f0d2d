"""Mamba2 / SSD (state-space duality) block (the reference's
``models/mamba2.py``, arXiv:2405.21060): the chunked parallel form for
training and prefill, and the one-token recurrence for decode.

Chunked SSD splits the sequence into chunks of ``chunk`` tokens. Within a
chunk the output is an attention-like quadratic form masked by the decay
kernel; across chunks a small (H, P, N) state is carried by a recurrence.
The reference has no Pallas kernel here (both forms are plain ``jax.lax``),
so the port has none either: plain torch, in float32 wherever the
reference casts to float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import rms_norm_simple


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device="cuda") -> Dict:
    s = cfg.ssm
    d = cfg.d_model
    din = s.d_inner(d)
    nh = s.n_heads(d)
    conv_dim = din + 2 * s.n_groups * s.d_state
    in_dim = 2 * din + 2 * s.n_groups * s.d_state + nh    # z, x, B, C, dt

    def rn(shape, std):
        return std * torch.randn(shape, generator=gen, dtype=dtype, device=device)

    # dt in [1e-3, 1e-1], log-uniform; dt_bias = softplus^-1(dt)
    u = torch.rand((nh,), generator=gen, dtype=torch.float32, device=device)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "in_proj": rn((d, in_dim), d ** -0.5),
        "conv_w": rn((conv_dim, s.d_conv), 0.1),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)).to(dtype),
        "D": torch.ones((nh,), dtype=dtype, device=device),
        "dt_bias": torch.log(torch.expm1(dt)).to(dtype),
        "scale": torch.ones((din,), dtype=dtype, device=device),   # gated RMSNorm
        "out_proj": rn((din, d), din ** -0.5),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) lower-triangular pairwise cumulative sums:
    out[i, j] = a[j+1] + ... + a[i] for i >= j, -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x (b,s,h,p), dt (b,s,h) >= 0, A (h,) < 0, B/C (b,s,g,n).
    The sequence is zero-padded to a multiple of ``chunk``; ``init_state``
    (b,h,p,n) is the state carried in from earlier tokens. Returns
    (y (b,s,h,p) float32, final_state (b,h,p,n) float32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    # groups to heads: head i reads group i // rep (jnp.repeat's order)
    Bh = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()
    Ch = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()

    a = (dtc * A.float()).movedim(-1, -2)                  # (b,nc,h,Q) decay logs
    a_cum = torch.cumsum(a, dim=-1)

    # 1) intra-chunk (quadratic within the chunk, like masked attention)
    L = torch.exp(_segsum(a))                              # (b,nc,h,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    xdt = xc * dtc[..., None]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores * L, xdt)

    # 2) chunk states: state_c = sum_k decay_to_end[k] * B_k (dt_k x_k)^T
    decay_end = torch.exp(a_cum[..., -1:] - a_cum)         # (b,nc,h,Q)
    states = torch.einsum("bcqhn,bchq,bcqhp->bchpn", Bh, decay_end, xdt)

    # 3) inter-chunk recurrence over the chunk states
    chunk_decay = torch.exp(a_cum[..., -1])                # (b,nc,h)
    st = (init_state.float() if init_state is not None
          else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(st)
        st = states[:, c] + chunk_decay[:, c, :, None, None] * st
    prev_states = torch.stack(prev, dim=1)                 # (b,nc,h,p,n)

    # 4) inter-chunk contribution: y_off = C_t . (decay_from_start_t * state_prev)
    y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Ch, prev_states, torch.exp(a_cum))
    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]
    return y, st


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence: x (b,h,p), dt (b,h), B/C (b,h,n), state
    (b,h,p,n) -> (y (b,h,p), new_state), in float32."""
    dec = torch.exp(dt.float() * A.float())                 # (b,h)
    upd = torch.einsum("bhn,bhp->bhpn", B.float(), (x * dt[..., None]).float())
    new_state = dec[..., None, None] * state + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, C.float())
    return y, new_state


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   cache: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x (B,S,C), w (C,K): ``w[:, K-1]`` multiplies
    the current token, ``w[:, 0]`` the one K-1 back. ``cache`` (B,K-1,C)
    holds the previous tokens (zeros without). Returns (y, new_cache)."""
    k = w.shape[-1]
    prefix = (x.new_zeros((x.shape[0], k - 1, x.shape[2])) if cache is None
              else cache.to(x.dtype))
    xp = torch.cat([prefix, x], dim=1)
    new_cache = xp[:, -(k - 1):, :]
    y = sum(xp[:, i:i + x.shape[1], :] * w[:, i] for i in range(k)) + b
    return y, new_cache


def apply_ssm(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
              cache: Optional[Dict] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The full Mamba2 block. ``cache`` = {"conv": (B,K-1,C), "state":
    (B,H,P,N)}: a one-token call runs the recurrence, a longer one the
    chunked form from the cached state. Returns (y, new cache or None)."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    din = s_cfg.d_inner(d)
    nh = s_cfg.n_heads(d)
    g, n = s_cfg.n_groups, s_cfg.d_state

    proj = x @ params["in_proj"].to(x.dtype)
    z, xin, Bc, Cc, dt = torch.split(proj, [din, din, g * n, g * n, nh], dim=-1)

    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out, new_conv = _conv1d_causal(conv_in, params["conv_w"].to(x.dtype),
                                        params["conv_b"].to(x.dtype),
                                        cache["conv"] if cache else None)
    conv_out = F.silu(conv_out)
    xin, Bc, Cc = torch.split(conv_out, [din, g * n, g * n], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = xin.reshape(b, s, nh, s_cfg.head_dim)
    Bh = Bc.reshape(b, s, g, n)
    Ch = Cc.reshape(b, s, g, n)

    new_cache = None
    if cache is not None and s == 1:
        rep = nh // g
        y1, new_state = ssd_decode_step(xh[:, 0], dt[:, 0], A,
                                        Bh[:, 0].repeat_interleave(rep, dim=1),
                                        Ch[:, 0].repeat_interleave(rep, dim=1),
                                        cache["state"])
        y = y1[:, None]
        new_cache = {"conv": new_conv, "state": new_state}
    else:
        y, final_state = ssd_chunked(xh, dt, A, Bh, Ch, s_cfg.chunk,
                                     cache["state"] if cache else None)
        if cache is not None:
            new_cache = {"conv": new_conv, "state": final_state}

    y = y + params["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, din).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm_simple(y, params["scale"])
    return y @ params["out_proj"].to(x.dtype), new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device="cuda") -> Dict:
    s = cfg.ssm
    d = cfg.d_model
    conv_dim = s.d_inner(d) + 2 * s.n_groups * s.d_state
    return {"conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                                device=device),
            "state": torch.zeros((batch, s.n_heads(d), s.head_dim, s.d_state),
                                 dtype=torch.float32, device=device)}
