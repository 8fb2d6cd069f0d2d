"""The plan layer around the CVMM kernels: inference-only forward parts of
the reference's ``kernels/ops.py``.

Layout plans
------------
``_tile_layout`` is the single source of the tile-aligned layout: rows
sorted by expert, each expert's range padded to a multiple of ``TM`` = 128,
so every row tile belongs to one expert. ``TM`` matches the reference, so
every integer field of a plan here equals the reference's exactly.

The TPU plans also carry a DMA chunk table (``run_start``/``run_len``/
``run_off``, built by ``ops._plan_runs``) because Pallas copies need static
shapes. The Hopper gather reads ``row_src`` directly, so the port's plans
leave that table out.

Entry points
------------
``cvmm_planned``           the sort path's grouped GEMM on a ``CvmmPlan``
                            (the unfused rung, K4).
``cvmm``                   the plain grouped rungs ("ragged", "ref").
``moe_mlp_decode``         serving's decode-shaped MoE MLP on a cached,
                            routing-free ``DecodePlan`` (K6 gather, then K4
                            three times).

All of it is forward-only: nothing here records a backward.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..common import act_fn, round_up
from . import cvmm as K
from . import ref as refk
from .cvmm import LANE, TM


def default_impl(device) -> str:
    """The sort path's rung: the K4 kernel on CUDA ("pallas" until the fused
    K1/K2 kernels are ported), the plain grouped matmul elsewhere."""
    return "pallas" if torch.device(device).type == "cuda" else "ragged"


def _pad_lane(a: torch.Tensor, axis: int) -> torch.Tensor:
    size = a.shape[axis]
    pad = round_up(size, LANE) - size
    if pad == 0:
        return a
    widths = [0, 0] * a.ndim
    widths[2 * (a.ndim - 1 - axis) + 1] = pad        # F.pad counts from the end
    return F.pad(a, widths)


def _pad_w(w: torch.Tensor) -> torch.Tensor:
    return _pad_lane(_pad_lane(w, 1), 2)


# ---------------------------------------------------------------------------
# Tile-aligned layout plan
# ---------------------------------------------------------------------------

def _tile_layout(group_sizes: torch.Tensor, m: int,
                 e: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Map sorted rows to a layout where each expert's range is TM-aligned.

    Returns (new_pos (m,), tile_expert (m_pad//TM,) int32, m_pad). m_pad is
    the static bound round_up(m, TM) + e*TM; slack tiles are clamped to the
    last expert."""
    dev = group_sizes.device
    gs = group_sizes.to(torch.int64)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    offs = torch.cat([zero, torch.cumsum(gs, 0)])[:-1]
    ps = ((gs + TM - 1) // TM) * TM                        # padded group sizes
    offs_p = torch.cat([zero, torch.cumsum(ps, 0)])[:-1]
    rows = torch.arange(m, dtype=torch.int64, device=dev)
    re = refk.row_experts(gs, m)
    new_pos = offs_p[re] + (rows - offs[re])
    m_pad = round_up(m, TM) + e * TM
    n_tiles = m_pad // TM
    ends_p = torch.cumsum(ps, 0)
    tile_expert = torch.searchsorted(
        ends_p, torch.arange(n_tiles, dtype=torch.int64, device=dev) * TM,
        right=True)
    tile_expert = torch.clamp(tile_expert, max=e - 1).to(torch.int32)
    return new_pos, tile_expert, m_pad


@dataclass(frozen=True)
class CvmmPlan:
    """Layout metadata of one MoE call, shared by its three grouped GEMMs:
    the fields of the reference's ``CvmmPlan`` that the unfused forward
    reads (the fused kernels' ``row_src``/``gate_tiles`` and the TPU DMA
    chunk table come with the slices that use them)."""
    perm: torch.Tensor          # (N*K,) stable argsort of flat expert ids
    group_sizes: torch.Tensor   # (E,) rows per expert
    new_pos: torch.Tensor       # (N*K,) tile-aligned slot of sorted row i
    tile_expert: torch.Tensor   # (M_pad//TM,) int32 row tile -> expert id


def make_moe_plan(idx: torch.Tensor, n_experts: int) -> CvmmPlan:
    """Build the CvmmPlan for one MoE call from the selected experts
    idx (N, K)."""
    e_flat = idx.reshape(-1).to(torch.int64)
    perm = torch.argsort(e_flat, stable=True)
    group_sizes = torch.bincount(e_flat, minlength=n_experts).to(torch.int32)
    new_pos, tile_expert, _ = _tile_layout(group_sizes, e_flat.shape[0],
                                           n_experts)
    return CvmmPlan(perm=perm, group_sizes=group_sizes, new_pos=new_pos,
                    tile_expert=tile_expert)


def _planned_fwd(x: torch.Tensor, new_pos: torch.Tensor,
                 tile_expert: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Scatter sorted rows into the tile-aligned layout, run K4, and read
    the real rows back."""
    n = w.shape[2]
    m_pad = tile_expert.shape[0] * TM
    x_pad = x.new_zeros((m_pad, round_up(x.shape[1], LANE)))
    x_pad[new_pos] = _pad_lane(x, 1)
    out_pad = K.cvmm(x_pad, tile_expert, _pad_w(w))
    return out_pad[new_pos, :n]


def cvmm_planned(x: torch.Tensor, plan: CvmmPlan,
                 w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul on *sorted* rows reusing a precomputed plan."""
    return _planned_fwd(x, plan.new_pos, plan.tile_expert, w.to(x.dtype))


def _ragged(x: torch.Tensor, group_sizes: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """Plain grouped matmul, one product per expert group in float32 (the
    stand-in for XLA's ragged_dot; reads group sizes on the host)."""
    out = x.new_empty((x.shape[0], w.shape[2]))
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        if size:
            rows = x[start:start + size].float()
            out[start:start + size] = (rows @ w[e].float()).to(x.dtype)
        start += size
    return out


def cvmm(x: torch.Tensor, group_sizes: torch.Tensor, w: torch.Tensor,
         impl: str) -> torch.Tensor:
    """The plain grouped rungs: rows of x (sorted by expert, sizes in
    group_sizes) times w (E, K, N). Returns (rows, N). The kernel rung runs
    through a plan instead (``cvmm_planned``)."""
    if impl == "ragged":
        return _ragged(x, group_sizes, w)
    if impl == "ref":
        return refk.cvmm_ref(x, group_sizes, w)
    raise ValueError(f"unknown cvmm impl {impl}")


# ---------------------------------------------------------------------------
# Deduplicated, row-index-sorted gather plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DedupGatherPlan:
    """Layout of one deduplicated row gather: every row the batch selects
    appears once in ``row_src``, ascending, followed by sentinel slack.
    ``sel_pos`` maps each flat (token, slot) selection to its compacted
    slot; ``tok_src``/``weights`` carry its destination token and weight."""
    row_src: torch.Tensor   # (U_pad,) int32 sorted unique rows; sentinel n_rows
    sel_pos: torch.Tensor   # (M,) compacted slot of flat selection (t, s)
    tok_src: torch.Tensor   # (M,) destination token of each selection
    weights: torch.Tensor   # (M,) float32 per-selection weight

    @property
    def u_pad(self) -> int:
        return self.row_src.shape[0]


def make_dedup_gather_plan(idx: torch.Tensor, weights: torch.Tensor,
                           n_rows: int) -> DedupGatherPlan:
    """idx (N, S) row ids into a table of ``n_rows`` rows, weights (N, S).

    The reference calls ``jnp.unique(size=min(N*S, n_rows), fill_value=
    n_rows)``; here the uniques come from ``torch.unique(sorted=True)`` and
    are padded with ``n_rows`` up to the same static size, rounded to TM."""
    n_tokens, s = idx.shape
    m = n_tokens * s
    u_pad = round_up(min(m, n_rows), TM)
    flat = idx.reshape(-1).to(torch.int64)
    uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
    row_src = torch.full((u_pad,), n_rows, dtype=torch.int32,
                         device=idx.device)
    row_src[:uniq.shape[0]] = uniq.to(torch.int32)
    tok_src = torch.arange(n_tokens, device=idx.device).repeat_interleave(s)
    return DedupGatherPlan(row_src=row_src, sel_pos=inv.reshape(-1),
                           tok_src=tok_src,
                           weights=weights.reshape(-1).float())


def dedup_gather_rows(values: torch.Tensor,
                      plan: DedupGatherPlan) -> torch.Tensor:
    """Per-selection rows through a dedup plan: rows[s] = V[idx[s]], lane-
    padded. One K6 pass covers the compacted union; ``sel_pos`` expands it
    back to selection order."""
    rows = K.gather_rows(_pad_lane(values, 1), plan.row_src)
    return rows[plan.sel_pos]


# ---------------------------------------------------------------------------
# Decode-shaped planned CVMM (serving: small-M steps on a cached skeleton)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DecodePlan:
    """Routing-free layout skeleton for one decode shape class.

    The per-expert capacity is the dropless worst case ``cap =
    round_up(n_tokens*k, TM)``, so ``m_pad = n_experts * cap`` and
    ``tile_expert`` is the static ``repeat(arange(e), cap//TM)``. ``gather``
    is the dedup plan over token rows (row_src == arange(n_tokens)).

    The reference also carries tuned tile widths (``w1_tn``/``w2_tn``,
    ``gather_nb``) from its autotuner. The port has no autotuner yet: its K4
    kernel uses one fixed 128 x 128 output tile and K6 one 128-row tile, so
    those fields are left out."""
    n_tokens: int
    k: int
    n_experts: int
    cap: int                      # per-expert slot capacity (TM multiple)
    tile_expert: torch.Tensor     # (n_experts * cap // TM,) int32
    gather: DedupGatherPlan       # token-row dedup gather

    @property
    def m_pad(self) -> int:
        return self.n_experts * self.cap


def make_decode_plan(n_tokens: int, k: int, n_experts: int, *,
                     device="cuda") -> DecodePlan:
    """Build the routing-free decode skeleton for one shape class."""
    cap = round_up(n_tokens * k, TM)
    tile_expert = torch.arange(n_experts, dtype=torch.int32,
                               device=device).repeat_interleave(cap // TM)
    tok = torch.arange(n_tokens, device=device)[:, None].expand(n_tokens, k)
    gather = make_dedup_gather_plan(
        tok, torch.ones((n_tokens, k), device=device), n_tokens)
    return DecodePlan(n_tokens=n_tokens, k=k, n_experts=n_experts, cap=cap,
                      tile_expert=tile_expert, gather=gather)


def decode_slots(plan: DecodePlan, idx: torch.Tensor) -> torch.Tensor:
    """Flat selection -> padded slot: a cumulative one-hot rank orders each
    selection within its expert, and ``slot = expert*cap + rank``."""
    e_flat = idx.reshape(-1).to(torch.int64)
    onehot = F.one_hot(e_flat, plan.n_experts)
    rank = torch.sum(torch.cumsum(onehot, 0) * onehot, 1) - 1
    return e_flat * plan.cap + rank


def moe_mlp_decode(xf: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor,
                   plan: DecodePlan, w1: torch.Tensor, w2: torch.Tensor,
                   w1g: Optional[torch.Tensor] = None, *,
                   activation: str = "relu") -> torch.Tensor:
    """y[t] = sum_k g[t,k] * w2[e]^T act(w1[e]^T x[t]) on a cached skeleton.

    xf (n, d) tokens, idx/gates (n, k) routing. Token rows go through K6
    once, scatter into the static expert-capacity layout, and run K4 for w1
    (and w1g) and w2; the gates combine the rows back per token in float32.

    Weights are expected in xf's dtype already: serving casts them once
    when the model is built (``LM.serving_params``), where the reference
    casts on every call. The ``.to`` below is then a no-op; from float32 it
    would read and write every expert weight on every step."""
    n, d = xf.shape
    if n != plan.n_tokens or idx.shape != (n, plan.k):
        raise ValueError(f"moe_mlp_decode: plan for {plan.n_tokens}x{plan.k}"
                         f" routing, got {tuple(idx.shape)}")
    d_pad = round_up(d, LANE)
    x_rows = dedup_gather_rows(xf, plan.gather)                # (n*k, d_pad)
    slot = decode_slots(plan, idx)
    x_pad = xf.new_zeros((plan.m_pad, d_pad))
    x_pad[slot] = x_rows
    h = K.cvmm(x_pad, plan.tile_expert, _pad_w(w1.to(xf.dtype)))
    u = act_fn(activation)(h)
    if w1g is not None:
        u = u * K.cvmm(x_pad, plan.tile_expert, _pad_w(w1g.to(xf.dtype)))
    y_pad = K.cvmm(u, plan.tile_expert, _pad_w(w2.to(xf.dtype)))
    rows = y_pad[slot].float() * gates.reshape(-1, 1).float()  # (n*k, d_pad)
    y = torch.zeros((n, d_pad), dtype=torch.float32, device=xf.device)
    y.index_add_(0, plan.gather.tok_src, rows)
    return y[:, :d].to(xf.dtype)
