"""The plan layer around the CVMM kernels: the parts of the reference's
``kernels/ops.py`` that the port runs.

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
``moe_mlp_fused``          the fused dropless expert MLP (the sort path's
                            default rung on CUDA): forward K1 then K2, and a
                            backward of K1, K3 and K4, as a
                            ``torch.autograd.Function``; gradients reach x,
                            the expert weights and, through the plan's
                            ``gate_tiles``, the router.
``cvmm_planned``           the unfused rung's grouped GEMM on a ``CvmmPlan``:
                            forward K4, backward K4 (dX) and K5 (dW), as a
                            ``torch.autograd.Function``.
``cvmm``                   the bare grouped matmul on sorted rows: the plain
                            rungs ("ragged", "ref"), or every "pallas*" name
                            through ``_tile_layout`` and that Function.
``plan_sort_kernels``      the sort path's rung for a shape class
                            (``set_default_impl``/``default_impl`` pin it).
``gathered_weighted_sum``  the weighted value sum on a ``GatherPlan`` (one
                            slot per selection): forward K6 with the weight
                            in its epilogue, backward K6 again for the
                            weights' gradient, as a
                            ``torch.autograd.Function``.
``gathered_weighted_sum_dedup``  the same on a ``DedupGatherPlan`` (each
                            selected row once): K6 forward and backward;
                            the main path of PKM and the top-K MLP
                            (``core/dispatch.weighted_value_sum``).
``moe_mlp_decode``         serving's decode-shaped MoE MLP on a cached,
                            routing-free ``DecodePlan`` (K6 gather, then K4
                            three times; forward only).
``assemble_decode_plan``   the full ``CvmmPlan`` a skeleton and one routing
                            imply, for the plan checker (the hot path stays
                            on the skeleton).
``plan_dma_stats``         a plan's row counts, optionally checked by
                            ``analysis.plans``.

Tile decisions
--------------
Each call resolves its kernels' launch schedules once, through the tuner
(``kernels/autotune.py``), and threads them into every launch of the call,
forward and backward: ``FusedTiles`` for the fused rung, ``PlannedTiles``
for each unfused grouped GEMM, and a ``DecodePlan``'s widths, decided when
the skeleton is built. ``SortKernelPlan`` carries the rung with its tiles.
A schedule depends on M_pad (the grid must fill the card), so the tiles are
resolved for a call's plan, not once per shape class as in the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..common import act_fn, round_up
from ..roofline.analysis import hardware_for
from . import autotune
from . import cvmm as K
from . import ref as refk
from .cvmm import LANE, TM

FUSIBLE_ACTIVATIONS = tuple(K.ACTIVATIONS)   # applied in K1's epilogue

_FORCED_IMPL: Optional[str] = None


def set_default_impl(impl: Optional[str]) -> None:
    """Pin the rung that ``impl="auto"`` resolves to (``None`` unpins).
    Global state: reset it in a ``finally``."""
    global _FORCED_IMPL
    _FORCED_IMPL = impl


def default_impl(device) -> str:
    """The sort path's rung: the pinned one if any; else the fused kernels
    on CUDA, as the reference's TPU default, and the plain grouped matmul
    elsewhere."""
    if _FORCED_IMPL:
        return _FORCED_IMPL
    return "pallas_fused" if torch.device(device).type == "cuda" else "ragged"


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


def _mask_empty(dw: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Zero the dW blocks of experts with no rows. The reference's dW
    kernels never visit them; the port's write zeros there already, so this
    is kept for parity and changes nothing."""
    return torch.where((group_sizes > 0)[:, None, None], dw, 0.0)


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
    m_pad = plan_m_pad(m, e)
    n_tiles = m_pad // TM
    ends_p = torch.cumsum(ps, 0)
    tile_expert = torch.searchsorted(
        ends_p, torch.arange(n_tiles, dtype=torch.int64, device=dev) * TM,
        right=True)
    tile_expert = torch.clamp(tile_expert, max=e - 1).to(torch.int32)
    return new_pos, tile_expert, m_pad


def plan_m_pad(n_rows: int, n_experts: int) -> int:
    """The static M_pad of ``_tile_layout`` for ``n_rows`` routed rows."""
    return round_up(n_rows, TM) + n_experts * TM


@dataclass(frozen=True)
class CvmmPlan:
    """Layout metadata of one MoE call, shared by every kernel launch of it,
    forward and backward: the reference's ``CvmmPlan`` without the TPU DMA
    chunk table (the Hopper kernels read ``row_src`` directly).
    ``gate_tiles`` is the one differentiable field: it is built from the
    gates by indexing, so the gates' gradient reaches the router."""
    perm: torch.Tensor          # (N*K,) stable argsort of flat expert ids
    group_sizes: torch.Tensor   # (E,) rows per expert
    new_pos: torch.Tensor       # (N*K,) tile-aligned slot of sorted row i
    row_src: torch.Tensor       # (M_pad,) int32 source token; sentinel N on slack
    tile_expert: torch.Tensor   # (M_pad//TM,) int32 row tile -> expert id
    gate_tiles: Optional[torch.Tensor]  # (M_pad//TM, TM) float32 gate per
    #                                     slot, 0 on slack (None: no gates)

    @property
    def m_pad(self) -> int:
        return self.tile_expert.shape[0] * TM


def make_moe_plan(idx: torch.Tensor, n_experts: int,
                  gates: Optional[torch.Tensor] = None) -> CvmmPlan:
    """Build the CvmmPlan for one MoE call from the selected experts
    idx (N, K) and, for the fused rung, their gates (N, K)."""
    n_tokens, k = idx.shape
    e_flat = idx.reshape(-1).to(torch.int64)
    perm = torch.argsort(e_flat, stable=True)
    group_sizes = torch.bincount(e_flat, minlength=n_experts).to(torch.int32)
    new_pos, tile_expert, m_pad = _tile_layout(group_sizes, e_flat.shape[0],
                                               n_experts)
    tok = torch.arange(n_tokens, dtype=torch.int32,
                       device=idx.device).repeat_interleave(k)
    row_src = torch.full((m_pad,), n_tokens, dtype=torch.int32,
                         device=idx.device)
    row_src[new_pos] = tok[perm]
    gate_tiles = None
    if gates is not None:
        gate_pad = torch.zeros((m_pad,), dtype=torch.float32, device=idx.device)
        gate_pad = gate_pad.index_put((new_pos,), gates.reshape(-1)[perm].float())
        gate_tiles = gate_pad.reshape(m_pad // TM, TM)
    return CvmmPlan(perm=perm, group_sizes=group_sizes, new_pos=new_pos,
                    row_src=row_src, tile_expert=tile_expert,
                    gate_tiles=gate_tiles)


# ---------------------------------------------------------------------------
# Tile decisions (one resolution per call, threaded into every launch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusedTiles:
    """The launch schedules of one fused MoE-MLP call, forward and backward
    (the reference's ``FusedTiles``: item widths where it has tile widths,
    K3's chunks where it has dW tiles and pipeline depths)."""
    w1_bn: int        # K1 forward, inference (one output)
    w1_train_bn: int  # K1 forward under grad (saves the pre-activations)
    t0_bn: int        # K1 backward, t0 = gather(dy) @ w2^T
    w2_bn: int        # K2 forward
    dx_bn: int        # K4 dX = dh @ w1^T (and dhg @ w1g^T)
    dw1_chunk: int    # K3 dW1 (and dW1g): K d_model, N expert_size
    dw2_chunk: int    # K3 dW2: K expert_size, N d_model
    provenance: str   # "heuristic" | "tuned" (any decision tuned)


@dataclass(frozen=True)
class PlannedTiles:
    """The launch schedules of one unfused grouped GEMM, forward and
    backward (the reference's ``PlannedTiles``)."""
    fwd_bn: int       # K4 x @ w
    dx_bn: int        # K4 g @ w^T
    dw_chunk: int     # K5 dW = x^T g
    provenance: str


def _merge_prov(*decisions) -> str:
    return ("tuned" if any(d.provenance == "tuned" for d in decisions)
            else "heuristic")


def _sms(device: torch.device) -> int:
    """The SM count a schedule is made for: the card's, or the hardware
    model's for the CPU (whose plain versions take no schedule)."""
    return K._sm_count(device) if device.type == "cuda" else hardware_for(device).n_sms


def _decide_bn(kernel: str, m_pad: int, n_experts: int, k_pad: int, n_pad: int, b: int,
               dev, glu: bool = False, save: bool = False) -> autotune.TileDecision:
    return autotune.decide("row_gemm", {
        "kernel": kernel, "m_pad": m_pad, "k_pad": k_pad, "n_pad": n_pad, "glu": glu,
        "save": save, "n_experts": n_experts, "b": b, "sms": _sms(dev)}, device=dev)


def _decide_chunk(kernel: str, m_pad: int, n_experts: int, k_pad: int, n_pad: int, b: int,
                  dev, stream_x: bool = False, gated: bool = False) -> autotune.TileDecision:
    return autotune.decide("dw_split", {
        "kernel": kernel, "m_pad": m_pad, "n_experts": n_experts, "k_pad": k_pad,
        "n_pad": n_pad, "b": b, "stream_x": int(stream_x), "gated": int(gated)}, device=dev)


def fused_mlp_tiles(m_pad: int, d_model: int, expert_size: int, n_experts: int,
                    dtype=torch.float32, glu: bool = False,
                    device="cuda") -> Optional[FusedTiles]:
    """Every schedule the fused rung launches for a plan of ``m_pad`` rows
    (forward and backward), or None when some launch has no legal one."""
    d_pad, g_pad = round_up(d_model, LANE), round_up(expert_size, LANE)
    b, dev = dtype.itemsize, torch.device(device)
    e = n_experts
    picks = [_decide_bn("fused_w1", m_pad, e, d_pad, g_pad, b, dev, glu=glu),
             _decide_bn("fused_w1", m_pad, e, d_pad, g_pad, b, dev, glu=glu, save=True),
             _decide_bn("fused_w1", m_pad, e, d_pad, g_pad, b, dev),
             _decide_bn("fused_w2", m_pad, e, g_pad, d_pad, b, dev),
             _decide_bn("cvmm", m_pad, e, g_pad, d_pad, b, dev),
             _decide_chunk("dw_streamed", m_pad, n_experts, d_pad, g_pad, b, dev,
                           stream_x=True),
             _decide_chunk("dw_streamed", m_pad, n_experts, g_pad, d_pad, b, dev,
                           gated=True)]
    if any(d.tiles is None for d in picks):
        return None
    w1, w1t, t0, w2, dx, dw1, dw2 = (d.tiles for d in picks)
    return FusedTiles(w1_bn=w1["bn"], w1_train_bn=w1t["bn"], t0_bn=t0["bn"],
                      w2_bn=w2["bn"], dx_bn=dx["bn"], dw1_chunk=dw1["chunk"],
                      dw2_chunk=dw2["chunk"], provenance=_merge_prov(*picks))


def planned_call_tiles(m_pad: int, k_dim: int, n_dim: int, n_experts: int,
                       dtype=torch.float32, device="cuda") -> Optional[PlannedTiles]:
    """The three schedules one unfused grouped GEMM of (K, N) = (``k_dim``,
    ``n_dim``) launches on a plan of ``m_pad`` rows (forward, dX, dW), or
    None when one has no legal schedule."""
    k_pad, n_pad = round_up(k_dim, LANE), round_up(n_dim, LANE)
    b, dev = dtype.itemsize, torch.device(device)
    picks = [_decide_bn("cvmm", m_pad, n_experts, k_pad, n_pad, b, dev),
             _decide_bn("cvmm", m_pad, n_experts, n_pad, k_pad, b, dev),
             _decide_chunk("cvmm_dw", m_pad, n_experts, k_pad, n_pad, b, dev)]
    if any(d.tiles is None for d in picks):
        return None
    fwd, dx, dw = (d.tiles for d in picks)
    return PlannedTiles(fwd_bn=fwd["bn"], dx_bn=dx["bn"], dw_chunk=dw["chunk"],
                        provenance=_merge_prov(*picks))


class _CvmmPlanned(torch.autograd.Function):
    """The reference's ``_cvmm_planned`` custom_vjp (``kernels/ops.py``):
    forward scatters the sorted rows into the tile-aligned layout and runs
    K4; backward pads the cotangent the same way and runs K4 on a contiguous
    w_pad^T for dX and K5 for dW, each at the call's ``PlannedTiles``. The
    residuals are the reference's: the padded rows, the plan arrays and w,
    so backward recomputes no layout."""

    @staticmethod
    def forward(ctx, x, new_pos, tile_expert, group_sizes, w, tiles):
        m_pad = tile_expert.shape[0] * TM
        x_pad = x.new_zeros((m_pad, round_up(x.shape[1], LANE)))
        x_pad[new_pos] = _pad_lane(x, 1)
        out_pad = K.cvmm(x_pad, tile_expert, _pad_w(w), bn=tiles.fwd_bn)
        ctx.save_for_backward(x_pad, new_pos, tile_expert, group_sizes, w)
        ctx.tiles = tiles
        return out_pad[new_pos, :w.shape[2]]

    @staticmethod
    def backward(ctx, g):
        x_pad, new_pos, tile_expert, group_sizes, w = ctx.saved_tensors
        e, k, n = w.shape
        g_pad = g.new_zeros((x_pad.shape[0], round_up(n, LANE)))
        g_pad[new_pos] = _pad_lane(g, 1)
        w_t = _pad_w(w).transpose(1, 2).contiguous()
        dx_pad = K.cvmm(g_pad, tile_expert, w_t, bn=ctx.tiles.dx_bn)
        dx = dx_pad[new_pos, :k].to(x_pad.dtype)
        dw = K.cvmm_dw(x_pad, tile_expert, g_pad, e, chunk=ctx.tiles.dw_chunk)
        dw = _mask_empty(dw, group_sizes)[:, :k, :n].to(w.dtype)
        return dx, None, None, None, dw, None


def _planned(x, new_pos, tile_expert, group_sizes, w, tiles):
    if tiles is None:
        tiles = planned_call_tiles(tile_expert.shape[0] * TM, x.shape[1], w.shape[2],
                                   w.shape[0], x.dtype, x.device)
    return _CvmmPlanned.apply(x, new_pos, tile_expert, group_sizes, w, tiles)


def cvmm_planned(x: torch.Tensor, plan: CvmmPlan, w: torch.Tensor,
                 tiles: Optional[PlannedTiles] = None) -> torch.Tensor:
    """Grouped matmul on *sorted* rows reusing a precomputed plan (the three
    calls of an MoE layer share one); differentiable in x and w. ``tiles``
    (``planned_call_tiles``) is resolved here when not given."""
    return _planned(x, plan.new_pos, plan.tile_expert, plan.group_sizes,
                    w.to(x.dtype), tiles)


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
         impl: Optional[str] = None) -> torch.Tensor:
    """Grouped matmul: rows of x (sorted by expert, sizes in group_sizes)
    times w (E, K, N). Returns (rows, N). Every "pallas*" name runs the
    unfused rung (K4 forward, K4 and K5 backward) on a layout derived here;
    "ragged" and "ref" are plain torch. ``None`` takes ``default_impl``."""
    impl = impl or default_impl(x.device)
    if impl == "ragged":
        return _ragged(x, group_sizes, w)
    if impl == "ref":
        return refk.cvmm_ref(x, group_sizes, w)
    if impl in ("pallas", "pallas_interpret", "pallas_fused",
                "pallas_fused_interpret"):
        new_pos, tile_expert, _ = _tile_layout(group_sizes, x.shape[0],
                                               w.shape[0])
        return _planned(x, new_pos, tile_expert, group_sizes.to(torch.int32),
                        w.to(x.dtype), None)
    raise ValueError(f"unknown cvmm impl {impl}")


# ---------------------------------------------------------------------------
# The sort path's rung
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SortKernelPlan:
    """The sort path's execution decision: the rung ("pallas_fused",
    "pallas" or "ragged") and, when resolved for a plan's M_pad, the
    schedules of every launch of it (the reference's fields)."""
    rung: str
    fused: Optional[FusedTiles] = None          # rung "pallas_fused"
    planned_w1: Optional[PlannedTiles] = None   # unfused w1/w1g (K d, N G)
    planned_w2: Optional[PlannedTiles] = None   # unfused w2 (K G, N d)

    @property
    def tiles(self):
        """The resolved schedules: ``FusedTiles``, the two ``PlannedTiles``
        of the unfused rung, or None."""
        if self.fused is not None:
            return self.fused
        if self.planned_w1 is not None:
            return (self.planned_w1, self.planned_w2)
        return None

    @property
    def provenance(self) -> str:
        if self.fused is not None:
            return self.fused.provenance
        if self.planned_w1 is not None:
            return _merge_prov(self.planned_w1, self.planned_w2)
        return "none"


def pallas_supported(d_model: int, expert_size: int,
                     dtype=torch.float32) -> bool:
    """Gate for the unfused kernel rung (K4 forward and dX, K5 dW).

    On the TPU the answer is whether every launch finds a tile that fits the
    VMEM budget. Here the kernels stream fixed slices of K and N through a
    shared-memory ring whose size does not grow with the widths (every
    instance fits the opt-in limit: ``analysis/smem.py``), so they take any
    width (d_model and expert_size are lane-padded to multiples of 128) in
    float32 or bfloat16, and nothing else. So the answer differs from the
    TPU's in two ways: a width too large for VMEM runs the kernels here, and
    a dtype other than float32 or bfloat16 (float16, say), which the TPU
    kernels take, goes to the plain "ragged" rung here, which runs on the
    CPU only."""
    del d_model, expert_size
    return dtype in (torch.float32, torch.bfloat16)


def fused_supported(n_tokens: int, d_model: int, expert_size: int,
                    activation: str, dtype=torch.float32,
                    glu: bool = False) -> bool:
    """Gate for the fused rung (K1, K2 forward; K1, K3, K4 backward): the
    activation must be tile-local (one of ``FUSIBLE_ACTIVATIONS``, applied
    in K1's epilogue; "softmax" spans a row's experts and is not), and the
    kernels must take the shapes and dtype (``pallas_supported``). The
    token count never matters: K1 and K3 read rows through ``row_src``."""
    del n_tokens, glu
    return (activation in FUSIBLE_ACTIVATIONS
            and pallas_supported(d_model, expert_size, dtype))


def plan_sort_kernels(impl: str, d_model: int, expert_size: int,
                      activation: str, dtype=torch.float32,
                      glu: bool = False, *, m_pad: Optional[int] = None,
                      n_experts: Optional[int] = None,
                      device=None) -> SortKernelPlan:
    """Resolve the sort path's rung in one place, as the reference does:
    a non-"pallas*" impl is "ragged"; "pallas*" degrades to "ragged" when
    the kernels do not take the shapes (``pallas_supported``); "pallas_fused*"
    runs fused when ``fused_supported`` and else the unfused "pallas" rung.
    Given a plan's ``m_pad``, its ``n_experts`` and the ``device``, the
    rung's own schedules are resolved too (the reference also resolves the
    unfused rung's for the fused one, which the port would only time for
    nothing); a launch without a legal schedule degrades the rung as the
    reference's missing tile does."""
    if not impl.startswith("pallas") or not pallas_supported(
            d_model, expert_size, dtype):
        return SortKernelPlan(rung="ragged")
    resolve = m_pad is not None
    if impl.startswith("pallas_fused") and fused_supported(
            0, d_model, expert_size, activation, dtype, glu):
        if not resolve:
            return SortKernelPlan(rung="pallas_fused")
        ft = fused_mlp_tiles(m_pad, d_model, expert_size, n_experts, dtype, glu, device)
        if ft is not None:
            return SortKernelPlan(rung="pallas_fused", fused=ft)
    if not resolve:
        return SortKernelPlan(rung="pallas")
    pw1 = planned_call_tiles(m_pad, d_model, expert_size, n_experts, dtype, device)
    pw2 = planned_call_tiles(m_pad, expert_size, d_model, n_experts, dtype, device)
    if pw1 is None or pw2 is None:
        return SortKernelPlan(rung="ragged")
    return SortKernelPlan(rung="pallas", planned_w1=pw1, planned_w2=pw2)


# ---------------------------------------------------------------------------
# Fused MoE-MLP pipeline (gather -> grouped GEMM -> epilogue), with backward
# ---------------------------------------------------------------------------

def _scatter_rows(rows: torch.Tensor, row_src: torch.Tensor, n: int,
                  width: int, dtype: torch.dtype) -> torch.Tensor:
    """Sum the padded rows back onto their n source rows in float32 and
    round once; slack rows (sentinel row_src == n) land on a dropped row."""
    out = torch.zeros((n + 1, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    out.index_add_(0, row_src.long(), rows.float())
    return out[:n, :width].to(dtype)


class _MoeMlpFused(torch.autograd.Function):
    """The reference's ``_moe_mlp_fused`` custom_vjp (``kernels/ops.py``):
    forward K1 (with the pre-activations saved under grad) then K2; backward
    t0 = gather(dy) @ w2^T by K1, the activation's elementwise VJP and
    dgate = sum(t0 * u) in plain torch, dW2 and dW1 (dW1g) by K3, dX by K4,
    every launch at the call's ``FusedTiles``. Weights arrive in x's dtype;
    each is padded once, in forward."""

    @staticmethod
    def forward(ctx, xf, gate, w1, w1g, w2, row_src, tile_expert, act,
                save_preact, tiles):
        n, d = xf.shape
        xe = _pad_lane(xf, 1)
        w1p, w2p = _pad_w(w1), _pad_w(w2)
        w1gp = None if w1g is None else _pad_w(w1g)
        out = K.fused_w1(xe, row_src, tile_expert, w1p, w1gp, act=act,
                         save_preact=save_preact,
                         bn=tiles.w1_train_bn if save_preact else tiles.w1_bn)
        u_pad = out[0] if save_preact else out
        y_pad = K.fused_w2(u_pad, tile_expert, w2p, gate, bn=tiles.w2_bn)
        if save_preact:
            ctx.save_for_backward(xe, gate, w1p, w1gp, w2p, row_src,
                                  tile_expert, *out[1:])
            ctx.act, ctx.shape, ctx.tiles = act, (n, d, w1.shape[2]), tiles
        return _scatter_rows(y_pad, row_src, n, d, xf.dtype)

    @staticmethod
    def backward(ctx, dy):
        xe, gate, w1p, w1gp, w2p, row_src, te, h, *hg = ctx.saved_tensors
        n, d, gsz = ctx.shape
        tiles = ctx.tiles
        e = w1p.shape[0]
        act = act_fn(ctx.act)
        dy_e = _pad_lane(dy.to(xe.dtype).contiguous(), 1)
        t0 = K.fused_w1(dy_e, row_src, te, w2p.transpose(1, 2).contiguous(),
                        None, act="identity", bn=tiles.t0_bn)
        with torch.enable_grad():              # the activation's VJP
            hv = h.detach().requires_grad_()
            ins = [hv]
            u = act(hv)
            if hg:
                ins.append(hg[0].detach().requires_grad_())
                u = u * ins[1]
        # d/dgate[r] = dy[r] . (u[r] @ w2[e]) = (dy[r] @ w2[e]^T) . u[r]
        dgate = torch.sum(t0.float() * u.detach().float(), dim=1)
        du = (t0.float() * gate[:, None]).to(u.dtype)
        dh, *dhg = torch.autograd.grad(u, ins, du)
        dw2 = K.dw_streamed(u.detach(), dy_e, row_src, te, e, stream_x=False,
                            gate=gate, chunk=tiles.dw2_chunk)[:, :gsz, :d]
        dw1 = K.dw_streamed(xe, dh, row_src, te, e, stream_x=True,
                            chunk=tiles.dw1_chunk)[:, :d, :gsz]
        dx_pad = K.cvmm(dh, te, w1p.transpose(1, 2).contiguous(), bn=tiles.dx_bn)
        dw1g = None
        if dhg:
            dw1g = K.dw_streamed(xe, dhg[0], row_src, te, e, stream_x=True,
                                 chunk=tiles.dw1_chunk)[:, :d, :gsz].to(xe.dtype)
            dx_pad = dx_pad + K.cvmm(dhg[0], te, w1gp.transpose(1, 2).contiguous(),
                                     bn=tiles.dx_bn)
        dx = _scatter_rows(dx_pad, row_src, n, d, xe.dtype)
        return (dx, dgate, dw1.to(xe.dtype), dw1g, dw2.to(xe.dtype),
                None, None, None, None, None)


def moe_mlp_fused(xf: torch.Tensor, plan: CvmmPlan, w1: torch.Tensor,
                  w2: torch.Tensor, w1g: Optional[torch.Tensor] = None, *,
                  activation: str = "relu",
                  tiles: Optional[FusedTiles] = None) -> torch.Tensor:
    """Fused dropless expert MLP:
    y[t] = sum_k gate * (act(x[t] @ w1[e]) [* x[t] @ w1g[e]]) @ w2[e].

    xf (N, d) UNSORTED activations; the gather, activation/GLU and gate
    multiply run inside the K1 and K2 launches; returns (N, d) with the
    per-(token, expert) rows summed back per token. Differentiable in xf,
    the weights and the plan's ``gate_tiles``. Weights are cast to xf's
    dtype here, as the reference does. ``tiles`` (``fused_mlp_tiles``) is
    resolved here when not given."""
    if activation not in FUSIBLE_ACTIVATIONS:
        raise ValueError(f"activation {activation!r} is not tile-local; "
                         f"fusible: {FUSIBLE_ACTIVATIONS}")
    if plan.gate_tiles is None:
        raise ValueError("moe_mlp_fused: the plan carries no gates; build it "
                         "with make_moe_plan(idx, n_experts, gates)")
    dt = xf.dtype
    ws = (w1.to(dt), None if w1g is None else w1g.to(dt), w2.to(dt))
    gate = plan.gate_tiles.reshape(-1)
    save = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (xf, gate) + ws)
    if tiles is None:
        tiles = fused_mlp_tiles(plan.m_pad, xf.shape[1], w1.shape[2], w1.shape[0], dt,
                                w1g is not None, xf.device)
        if tiles is None:
            raise ValueError("moe_mlp_fused: a launch has no schedule within the "
                             "shared-memory budget")
    return _MoeMlpFused.apply(xf, gate, *ws, plan.row_src, plan.tile_expert,
                              activation, save, tiles)


# ---------------------------------------------------------------------------
# Weighted row-gather plan (PKM values, the top-K MLP's W2 rows)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GatherPlan:
    """Layout of one weighted row gather-sum: one slot per flat (token,
    slot) selection, in that order, padded to a multiple of TM. The
    reference's ``GatherPlan`` without the TPU DMA chunk table;
    ``weight_tiles`` is the one differentiable field."""
    row_src: torch.Tensor       # (M_pad,) int32 table row; sentinel n_rows on slack
    tok_src: torch.Tensor       # (M_pad,) int32 token; sentinel n_tokens on slack
    weight_tiles: torch.Tensor  # (M_pad//TM, TM) float32 weight, 0 on slack

    @property
    def m_pad(self) -> int:
        return self.weight_tiles.shape[0] * TM


def make_gather_plan(idx: torch.Tensor, weights: torch.Tensor,
                     n_rows: int) -> GatherPlan:
    """idx (N, S) row ids into a table of ``n_rows`` rows, weights (N, S);
    differentiable in ``weights``."""
    n_tokens, s = idx.shape
    m = n_tokens * s
    pad = round_up(m, TM) - m
    tok = torch.arange(n_tokens, dtype=torch.int32, device=idx.device)
    row_src = F.pad(idx.reshape(-1).to(torch.int32), (0, pad), value=n_rows)
    tok_src = F.pad(tok.repeat_interleave(s), (0, pad), value=n_tokens)
    w = F.pad(weights.reshape(-1).float(), (0, pad))
    return GatherPlan(row_src=row_src, tok_src=tok_src,
                      weight_tiles=w.reshape(-1, TM))


def gather_supported(d_model: int, dtype=torch.float32) -> bool:
    """Gate for the K6 rungs of the weighted value sum. On the TPU the
    answer is whether a (TM, d_pad) tile ring fits VMEM. K6 keeps no shared
    memory (each warp copies its slice of a row straight through), so it
    takes any lane-padded width in float32 or bfloat16, and nothing else:
    a width too large for VMEM runs K6 here, and another dtype goes to the
    einsum rung."""
    del d_model
    return dtype in (torch.float32, torch.bfloat16)


class _GatheredWeightedSum(torch.autograd.Function):
    """The reference's ``_gathered_weighted_sum`` custom_vjp: forward K6
    with the weight in its epilogue (``fuse``) or K6 then the multiply, the
    rows summed per token in float32 and rounded once; backward K6 again
    (unweighted) for the weights' gradient, and dy[tok] * w summed into the
    table in float32, rounded once (the reference sums in the table's
    dtype). Residuals: the padded table and the plan."""

    @staticmethod
    def forward(ctx, values_pad, weight, row_src, tok_src, n_tokens, fuse):
        if fuse:
            rows = K.gather_rows(values_pad.detach(), row_src, weight.detach())
        else:
            rows = K.gather_rows(values_pad.detach(), row_src)
            rows = (rows.float() * weight[:, None]).to(rows.dtype)
        ctx.save_for_backward(values_pad, weight, row_src, tok_src)
        return _scatter_rows(rows, tok_src, n_tokens, rows.shape[1], rows.dtype)

    @staticmethod
    def backward(ctx, dy):
        values_pad, weight, row_src, tok_src = ctx.saved_tensors
        # a sentinel token reads the appended zero row
        dy_rows = torch.cat([dy.float(), dy.new_zeros((1, dy.shape[1]),
                                                      dtype=torch.float32)])
        dy_rows = dy_rows[tok_src.long()]
        dvalues = dweight = None
        if ctx.needs_input_grad[1]:
            rows = K.gather_rows(values_pad.detach(), row_src)
            dweight = torch.sum(rows.float() * dy_rows, dim=1)
            del rows
        if ctx.needs_input_grad[0]:
            dvalues = _scatter_rows(dy_rows * weight[:, None], row_src,
                                    values_pad.shape[0], values_pad.shape[1],
                                    values_pad.dtype)
        return dvalues, dweight, None, None, None, None


def gathered_weighted_sum(values: torch.Tensor, plan: GatherPlan,
                          n_tokens: int, *,
                          fuse_weights: bool = True) -> torch.Tensor:
    """y[t] = sum_{s: tok[s]=t} w[s] * values[row[s]]  (n_tokens, d), one K6
    slot per selection; differentiable in ``values`` and the plan's
    ``weight_tiles``. ``fuse_weights=False`` multiplies outside K6."""
    d = values.shape[-1]
    y = _GatheredWeightedSum.apply(_pad_lane(values, 1),
                                   plan.weight_tiles.reshape(-1), plan.row_src,
                                   plan.tok_src, n_tokens, fuse_weights)
    return y[:, :d]


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


def _selections(rows: torch.Tensor, sel_pos: torch.Tensor,
                n_tokens: int) -> torch.Tensor:
    """The compacted rows expanded to selection order in float32, (N, S,
    d_pad): a dedup plan's ``tok_src`` is token-major by construction
    (selection t*S + s belongs to token t)."""
    if sel_pos.numel() % n_tokens:
        raise ValueError(f"a dedup plan of {sel_pos.numel()} selections "
                         f"does not split into {n_tokens} tokens")
    return rows.float()[sel_pos].view(n_tokens, -1, rows.shape[1])


class _GatheredWeightedSumDedup(torch.autograd.Function):
    """The reference's ``_gathered_weighted_sum_dedup`` custom_vjp. Forward:
    K6 copies the plan's compacted union of rows once; ``sel_pos`` expands
    it back to the selections, weighted and summed per token in float32
    (a reshape-sum: ``tok_src`` is token-major), rounded once. Backward: K6
    again for dweight[s] = dy[tok[s]] . V[idx[s]], and dV in two float32
    levels, the selections into the compacted block, then the block into
    the table, cast once (slack rows land on an appended row that is
    dropped). Residuals: the padded table and the plan, not the (M, d)
    rows."""

    @staticmethod
    def forward(ctx, values_pad, weights, row_src, sel_pos, n_tokens):
        rows = K.gather_rows(values_pad.detach(), row_src)
        sel = _selections(rows, sel_pos, n_tokens)
        y = torch.bmm(weights.view(n_tokens, 1, -1), sel).view(n_tokens, -1)
        ctx.save_for_backward(values_pad, weights, row_src, sel_pos)
        ctx.n_tokens = n_tokens
        return y.to(rows.dtype)

    @staticmethod
    def backward(ctx, dy):
        values_pad, weights, row_src, sel_pos = ctx.saved_tensors
        n, width = ctx.n_tokens, values_pad.shape[1]
        dyf = dy.float()
        dvalues = dweights = None
        if ctx.needs_input_grad[1]:
            sel = _selections(K.gather_rows(values_pad.detach(), row_src),
                              sel_pos, n)
            dweights = torch.bmm(sel, dyf.reshape(n, width, 1)).view(-1)
            del sel
        if ctx.needs_input_grad[0]:
            prod = weights.view(n, -1, 1) * dyf.reshape(n, 1, width)
            dcompact = torch.zeros((row_src.shape[0], width), dtype=torch.float32,
                                   device=dy.device)
            dcompact.index_add_(0, sel_pos, prod.view(-1, width))
            del prod
            dvalues = values_pad.new_zeros((values_pad.shape[0] + 1, width))
            dvalues.index_copy_(0, row_src.long(), dcompact.to(values_pad.dtype))
            dvalues = dvalues[:-1]
        return dvalues, dweights, None, None, None


def gathered_weighted_sum_dedup(values: torch.Tensor, plan: DedupGatherPlan,
                                n_tokens: int) -> torch.Tensor:
    """y[t] = sum_s w[t, s] * values[idx[t, s]]  (n_tokens, d) through a
    dedup plan: each selected row passes K6 once, forward and backward.
    Differentiable in ``values`` and the plan's ``weights``."""
    d = values.shape[-1]
    y = _GatheredWeightedSumDedup.apply(_pad_lane(values, 1), plan.weights,
                                        plan.row_src, plan.sel_pos, n_tokens)
    return y[:, :d]


def dedup_gather_rows(values: torch.Tensor, plan: DedupGatherPlan, *,
                      schedule: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Per-selection rows through a dedup plan: rows[s] = V[idx[s]], lane-
    padded. One K6 pass (at ``schedule``, or the tuner's) covers the
    compacted union; ``sel_pos`` expands it back to selection order."""
    rows = K.gather_rows(_pad_lane(values, 1), plan.row_src, schedule=schedule)
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

    Built for the expert widths, the skeleton also carries the schedules
    of its launches, decided once by the tuner when it is built (the
    reference's ``w1_tn``, ``w2_tn`` and ``gather_nb``): K4's item width for
    w1 (and w1g) and for w2, and K6's (rows a block, vectors a lane). A
    skeleton built without widths leaves them None, and each launch
    decides its own (the same in the default, heuristic mode)."""
    n_tokens: int
    k: int
    n_experts: int
    cap: int                      # per-expert slot capacity (TM multiple)
    tile_expert: torch.Tensor     # (n_experts * cap // TM,) int32
    gather: DedupGatherPlan       # token-row dedup gather
    d_model: Optional[int] = None
    expert_size: Optional[int] = None
    w1_bn: Optional[int] = None   # K4 item widths: w1 (d -> G), w2 (G -> d)
    w2_bn: Optional[int] = None
    gather_schedule: Optional[Tuple[int, int]] = None   # K6 (rows, vectors a lane)
    provenance: str = "none"      # "heuristic" | "tuned" | "none" (no widths)

    @property
    def m_pad(self) -> int:
        return self.n_experts * self.cap


def make_decode_plan(n_tokens: int, k: int, n_experts: int,
                     d_model: Optional[int] = None, expert_size: Optional[int] = None,
                     dtype=torch.bfloat16, *, device="cuda") -> DecodePlan:
    """Build the routing-free decode skeleton for one shape class, with its
    launches' schedules when ``d_model`` and ``expert_size`` are given."""
    cap = round_up(n_tokens * k, TM)
    tile_expert = torch.arange(n_experts, dtype=torch.int32,
                               device=device).repeat_interleave(cap // TM)
    tok = torch.arange(n_tokens, device=device)[:, None].expand(n_tokens, k)
    gather = make_dedup_gather_plan(
        tok, torch.ones((n_tokens, k), device=device), n_tokens)
    plan = DecodePlan(n_tokens=n_tokens, k=k, n_experts=n_experts, cap=cap,
                      tile_expert=tile_expert, gather=gather)
    if d_model is None or expert_size is None:
        return plan
    dev, b = torch.device(device), dtype.itemsize
    d_pad, g_pad = round_up(d_model, LANE), round_up(expert_size, LANE)
    m_pad = n_experts * cap
    w1 = _decide_bn("cvmm", m_pad, n_experts, d_pad, g_pad, b, dev)
    w2 = _decide_bn("cvmm", m_pad, n_experts, g_pad, d_pad, b, dev)
    gr = autotune.decide("gather_rows", {"m_pad": gather.u_pad, "row_bytes": d_pad * b,
                                         "sms": _sms(dev)}, device=dev)
    if any(d.tiles is None for d in (w1, w2, gr)):
        raise ValueError(f"make_decode_plan: no schedule within the shared-memory "
                         f"budget for d_model {d_model}, expert_size {expert_size}")
    return dataclasses.replace(
        plan, d_model=d_model, expert_size=expert_size, w1_bn=w1.tiles["bn"],
        w2_bn=w2.tiles["bn"], gather_schedule=(gr.tiles["rows"], gr.tiles["vpl"]),
        provenance=_merge_prov(w1, w2, gr))


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
    if plan.d_model is not None and (plan.d_model, plan.expert_size) != (d, w1.shape[2]):
        raise ValueError(f"moe_mlp_decode: plan for widths {plan.d_model} and "
                         f"{plan.expert_size}, got {d} and {w1.shape[2]}")
    d_pad = round_up(d, LANE)
    x_rows = dedup_gather_rows(xf, plan.gather,
                               schedule=plan.gather_schedule)  # (n*k, d_pad)
    slot = decode_slots(plan, idx)
    x_pad = xf.new_zeros((plan.m_pad, d_pad))
    x_pad[slot] = x_rows
    h = K.cvmm(x_pad, plan.tile_expert, _pad_w(w1.to(xf.dtype)), bn=plan.w1_bn)
    u = act_fn(activation)(h)
    if w1g is not None:
        u = u * K.cvmm(x_pad, plan.tile_expert, _pad_w(w1g.to(xf.dtype)),
                       bn=plan.w1_bn)
    y_pad = K.cvmm(u, plan.tile_expert, _pad_w(w2.to(xf.dtype)), bn=plan.w2_bn)
    rows = y_pad[slot].float() * gates.reshape(-1, 1).float()  # (n*k, d_pad)
    y = torch.zeros((n, d_pad), dtype=torch.float32, device=xf.device)
    y.index_add_(0, plan.gather.tok_src, rows)
    return y[:, :d].to(xf.dtype)


def assemble_decode_plan(plan: DecodePlan, idx: torch.Tensor,
                         gates: torch.Tensor) -> CvmmPlan:
    """The full ``CvmmPlan`` that the skeleton and one routing imply (the
    reference's second level). ``moe_mlp_decode`` never needs it; the plan
    checker (``analysis/plans.py``) holds the decode layout to the same
    invariants as every other plan through it. Slots follow
    ``decode_slots``; ``tile_expert`` is the skeleton's."""
    k = idx.shape[-1]
    dev = plan.tile_expert.device
    e_flat = idx.reshape(-1).to(torch.int64)
    tok = torch.arange(plan.n_tokens, dtype=torch.int32, device=dev).repeat_interleave(k)
    perm = torch.argsort(e_flat, stable=True)
    group_sizes = torch.bincount(e_flat, minlength=plan.n_experts).to(torch.int32)
    new_pos = decode_slots(plan, idx)[perm]
    row_src = torch.full((plan.m_pad,), plan.n_tokens, dtype=torch.int32, device=dev)
    row_src[new_pos] = tok[perm]
    gate_pad = torch.zeros((plan.m_pad,), dtype=torch.float32, device=dev)
    gate_pad[new_pos] = gates.reshape(-1)[perm].float()
    return CvmmPlan(perm=perm, group_sizes=group_sizes, new_pos=new_pos,
                    row_src=row_src, tile_expert=plan.tile_expert,
                    gate_tiles=gate_pad.reshape(plan.m_pad // TM, TM))


def plan_dma_stats(plan, n_rows: int, *, verify: bool = False) -> dict:
    """A plan's row counts (the reference's telemetry, as far as the port's
    plans carry it): ``per_row``, the slots that read a row (for a
    ``DedupGatherPlan`` the selections before the dedup), and for a dedup
    plan ``unique_rows``, the rows it reads. The port's plans carry no DMA
    chunk table, so there is no ``chunk_hist`` or ``run_batched``.
    ``verify=True`` first runs the plan through ``analysis.plans`` and
    raises ValueError on any violation."""
    if verify:
        from ..analysis.plans import verify_plan
        findings = verify_plan(plan, n_rows)
        if findings:
            raise ValueError("plan invariant violations:\n" + "\n".join(
                f"  [{f.check}] {f.detail}" for f in findings))
    real = int((plan.row_src < n_rows).sum())
    if isinstance(plan, DedupGatherPlan):
        return {"per_row": int(plan.sel_pos.shape[0]), "unique_rows": real}
    return {"per_row": real}
