"""Selection -> planned execution (the reference's ``core/dispatch.py``,
on one device): the MoE expert MLP and the weighted value sum.

``weighted_value_sum`` is the aggregation the paper's row-selecting
approximators share: PKM's values (``core/pkm.py``) and the top-K MLP's W2
rows (``core/topk_mlp.py``) are value tables, and a ``Selection`` names the
rows each token takes and their weights. ``value_sum_path`` picks the rung:

  pallas_fused,  ``ops.gathered_weighted_sum_dedup``: the union of the
  pallas        batch's selections, deduplicated and sorted, goes through
                K6 once (and once more in backward); the weights apply
                in plain torch as the rows expand back to the tokens.
  einsum        ``dense_value_gather`` then an einsum, the reference
                semantics: only an explicit ``impl`` or a dtype K6 does
                not take (``ops.gather_supported``) reaches it; it is
                "auto" on the CPU, where "ragged" is the default. CPU
                only, as is "dense": on CUDA they raise.

``expert_mlp`` runs one MoE layer's experts at a fixed selection, by the
config's ``dispatch``. "einsum" is the GShard capacity path
(``_einsum_path``): each expert takes at most ``_capacity`` (token, expert)
pairs in selection order into an (E, C, d) buffer, the rest are dropped
and reported, and three batched products (``torch.bmm``, as the
reference's einsums, which no Pallas kernel computes) run the experts.
Within the "sort" dispatch (the paper's dropless CVMM) ``resolve_impl``
names an impl and ``ops.plan_sort_kernels`` turns it into the rung, as in
the reference:

  pallas_fused   the fused pipeline (``ops.moe_mlp_fused``): one CvmmPlan
                 per call, K1 and K2 forward, K1, K3 and K4 backward.
                 "auto" on CUDA, as on the reference's TPU. An activation
                 that is not tile-local ("softmax") degrades it to "pallas".
  pallas         the unfused planned rung (``ops.cvmm_planned``): the gather
                 and the gate-weighted scatter-add in plain torch, K4 for w1
                 (w1g) and w2 forward, K4 (dX) and K5 (dW) for each in
                 backward. Pin it with ``ops.set_default_impl("pallas")``.
  ragged / ref   plain grouped matmuls, the stand-ins for XLA's ragged_dot
                 and the one-hot oracle; "auto" on the CPU. CPU only.

On the CPU the kernel rungs run the kernels' plain versions. The reference's ``*_interpret`` names select the same rungs here.

Serving installs a decode provider (``set_decode_provider``) that claims
small calls and runs them on a cached routing-free DecodePlan
(``ops.moe_mlp_decode``). The reference also pins the sort path to
replicated under an active device mesh and constrains the capacity
buffers to expert sharding; the port has no mesh yet, so neither is
there, and the "shard_map" dispatch raises (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..common import act_fn, cdiv, round_up
from ..configs.base import FFNConfig
from ..kernels import ops as kops
from .routing import SelectionInfo


def base_aux(device=None) -> Dict[str, torch.Tensor]:
    """The uniform aux contract: every FFN kind returns at least these, as
    float32 scalars on ``device``."""
    return {"moe_reg": torch.zeros((), dtype=torch.float32, device=device),
            "moe_dropped": torch.zeros((), dtype=torch.float32, device=device)}


class Selection(NamedTuple):
    """Which rows of a value table each token selected, and their weights."""
    idx: torch.Tensor        # (N, S) int row ids
    weights: torch.Tensor    # (N, S) aggregation weights
    n_items: int             # rows of the table (E / n_values / d_ff)


def selection_usage(sel: Selection) -> Dict[str, torch.Tensor]:
    """Usage histogram over the selected rows (paper Fig. 3/7): counts,
    summed weights and the counts' entropy, all float32."""
    flat = sel.idx.reshape(-1).long()
    counts = torch.bincount(flat, minlength=sel.n_items).float()
    weight = torch.zeros(sel.n_items, dtype=torch.float32, device=flat.device
                         ).index_add_(0, flat, sel.weights.reshape(-1).float())
    frac = counts / (torch.sum(counts) + 1e-9)
    ent = -torch.sum(frac * torch.log(frac + 1e-9))
    return {"counts": counts, "weight": weight, "usage_entropy": ent}


def resolve_impl(cfg: FFNConfig, device) -> str:
    """Per-layer impl knob: cfg.impl, with "auto" deferring to the pinned or
    the device's default rung (``ops.default_impl``)."""
    return kops.default_impl(device) if cfg.impl == "auto" else cfg.impl


# ---------------------------------------------------------------------------
# Weighted value aggregation (PKM values / top-K W2 rows)
# ---------------------------------------------------------------------------

def dense_value_gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The einsum rung's (N, S, d) gather; no kernel rung calls it."""
    return values[idx]


def value_sum_path(cfg: FFNConfig, d_model: int, dtype, device) -> str:
    """The rung ``weighted_value_sum`` runs for this config, feature width,
    dtype and device: "dense" (the approximators' own oracle), "pallas_fused"
    or "pallas" (K6), or "einsum". "dense" and "einsum" are plain CPU rungs:
    on CUDA a config or dtype that leads to them raises."""
    impl = resolve_impl(cfg, device)
    if impl == "dense":
        path = "dense"
    elif impl.startswith("pallas") and kops.gather_supported(d_model, dtype):
        path = "pallas_fused" if impl.startswith("pallas_fused") else "pallas"
    else:
        path = "einsum"
    if torch.device(device).type == "cuda" and not path.startswith("pallas"):
        raise NotImplementedError(
            f"the weighted value sum's {path!r} rung (impl={impl!r}, {dtype}) "
            "is a plain CPU rung; on CUDA use 'pallas_fused' or 'pallas' with "
            "a float32 or bfloat16 table")
    return path


def weighted_value_sum(values: torch.Tensor, sel: Selection, n_tokens: int,
                       cfg: FFNConfig) -> torch.Tensor:
    """y[t] = sum_s sel.weights[t, s] * values[sel.idx[t, s]]  (N, d), on
    the rung ``value_sum_path`` names. The kernel rungs build one
    ``DedupGatherPlan`` a call; "dense" computes the einsum rung's sum."""
    path = value_sum_path(cfg, values.shape[-1], values.dtype, values.device)
    if path in ("pallas_fused", "pallas"):
        plan = kops.make_dedup_gather_plan(sel.idx, sel.weights, values.shape[0])
        return kops.gathered_weighted_sum_dedup(values, plan, n_tokens)
    rows = dense_value_gather(values, sel.idx)
    return torch.einsum("ns,nsd->nd", sel.weights.to(rows.dtype), rows)


def _expert_ffn(cfg: FFNConfig, h_pre: torch.Tensor, h_gate) -> torch.Tensor:
    u = act_fn(cfg.activation)(h_pre)
    if cfg.glu_experts:
        u = u * h_gate
    return u


def _sort_path(params: Dict, xf: torch.Tensor, cfg: FFNConfig,
               info: SelectionInfo, e: int) -> torch.Tensor:
    """Dropless grouped matmul (paper Eq. 11): flatten (token, k) pairs,
    stable-sort by expert, grouped matmuls, gate-weighted scatter-add back
    to the tokens."""
    n, d = xf.shape
    k = cfg.k
    impl = resolve_impl(cfg, xf.device)
    if impl in ("einsum", "dense"):
        impl = "ragged"
    skp = None
    if impl.startswith("pallas"):
        skp = kops.plan_sort_kernels(impl, d, cfg.expert_size, cfg.activation, xf.dtype,
                                     glu=cfg.glu_experts, m_pad=kops.plan_m_pad(n * k, e),
                                     n_experts=e, device=xf.device)
        impl = skp.rung
    if xf.device.type == "cuda" and not impl.startswith("pallas"):
        raise NotImplementedError(
            f"impl={impl!r} is a plain CPU rung; on CUDA use 'pallas_fused' "
            "or 'pallas'")

    w1 = params["we1"].to(xf.dtype)
    w2 = params["we2"].to(xf.dtype)
    w1g = params["we1g"].to(xf.dtype) if cfg.glu_experts else None
    if impl == "pallas_fused":
        plan = kops.make_moe_plan(info.idx, e, info.gates)
        return kops.moe_mlp_fused(xf, plan, w1, w2, w1g,
                                  activation=cfg.activation, tiles=skp.fused)

    tok = torch.arange(n, device=xf.device).repeat_interleave(k)
    g_flat = info.gates.reshape(-1)
    if impl == "pallas":
        plan = kops.make_moe_plan(info.idx, e)
        src = tok[plan.perm]
        x_sorted = xf[src]
        h = kops.cvmm_planned(x_sorted, plan, w1, skp.planned_w1)
        hg = (kops.cvmm_planned(x_sorted, plan, w1g, skp.planned_w1)
              if cfg.glu_experts else None)
        y_sorted = kops.cvmm_planned(_expert_ffn(cfg, h, hg), plan, w2, skp.planned_w2)
        y_sorted = y_sorted * g_flat[plan.perm][:, None].to(y_sorted.dtype)
        return torch.zeros_like(xf).index_add_(0, src, y_sorted)

    e_flat = info.idx.reshape(-1).to(torch.int64)
    perm = torch.argsort(e_flat, stable=True)
    src = tok[perm]
    x_sorted = xf[src]
    group_sizes = torch.bincount(e_flat, minlength=e)
    h = kops.cvmm(x_sorted, group_sizes, w1, impl=impl)
    hg = kops.cvmm(x_sorted, group_sizes, w1g, impl=impl) if cfg.glu_experts else None
    y_sorted = kops.cvmm(_expert_ffn(cfg, h, hg), group_sizes, w2, impl=impl)
    y_sorted = y_sorted * g_flat[perm][:, None].to(y_sorted.dtype)
    return torch.zeros_like(xf).index_add_(0, src, y_sorted)


def _capacity(n_tokens: int, k: int, e: int, factor: float,
              multiple: int = 8) -> int:
    """Rows of each expert's capacity buffer: ``factor`` times the mean
    load n*k/E, rounded up to ``multiple``."""
    return max(multiple, round_up(int(cdiv(n_tokens * k, e) * factor), multiple))


def _pack_capacity(xf: torch.Tensor, info: SelectionInfo, e: int, cap: int):
    """Scatter the (token, k) pairs into an (E, C, d) buffer, each at its
    rank among its expert's pairs in (token, k) order; pairs ranked at or
    past ``cap`` are dropped: they go to slot (0, 0) with a zero row, as in
    the reference, so the buffer is the reference's. Returns (buffer,
    (tok, e_safe, p_safe, keep)).

    The ranks come from a stable sort by expert (the reference takes a
    cumulative sum over an (N*K, E) one-hot, a slow scan on the card), and
    the buffer is built with ``index_add`` on its (E*C, d) rows, whose
    atomic adds take the dropped pairs' zeros at slot (0, 0) without the
    serial duplicate walk of ``index_put(accumulate=True)``."""
    n, d = xf.shape
    k = info.idx.shape[-1]
    e_flat = info.idx.reshape(-1).long()
    order = torch.argsort(e_flat, stable=True)
    counts = torch.bincount(e_flat, minlength=e)
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.empty_like(e_flat)
    pos[order] = torch.arange(e_flat.numel(), device=xf.device) - starts[e_flat[order]]
    keep = pos < cap
    tok = torch.arange(n, device=xf.device).repeat_interleave(k)
    e_safe = torch.where(keep, e_flat, 0)
    p_safe = torch.where(keep, pos, 0)
    rows = xf[tok] * keep[:, None].to(xf.dtype)
    buf = xf.new_zeros((e * cap, d)).index_add(0, e_safe * cap + p_safe, rows)
    return buf.view(e, cap, d), (tok, e_safe, p_safe, keep)


def _combine_capacity(buf_out: torch.Tensor, info: SelectionInfo, meta,
                      n: int) -> torch.Tensor:
    """Each kept pair's output row times its gate, summed onto its token."""
    tok, e_safe, p_safe, keep = meta
    e, cap, d = buf_out.shape
    g_flat = info.gates.reshape(-1)
    rows = buf_out.reshape(e * cap, d).index_select(0, e_safe * cap + p_safe)
    rows = rows * (g_flat * keep.to(g_flat.dtype))[:, None].to(rows.dtype)
    return buf_out.new_zeros((n, d)).index_add(0, tok, rows)


def _einsum_path(params: Dict, xf: torch.Tensor, cfg: FFNConfig,
                 info: SelectionInfo, e: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity ("einsum") dispatch: pack, three batched products over
    the (E, C, ·) buffers, combine. Returns (y (N, d), the dropped share of
    the (token, k) pairs, float32)."""
    n, d = xf.shape
    cap = _capacity(n, cfg.k, e, cfg.capacity_factor)
    buf, meta = _pack_capacity(xf, info, e, cap)
    h = torch.bmm(buf, params["we1"].to(xf.dtype))
    hg = torch.bmm(buf, params["we1g"].to(xf.dtype)) if cfg.glu_experts else None
    buf_out = torch.bmm(_expert_ffn(cfg, h, hg), params["we2"].to(xf.dtype))
    y = _combine_capacity(buf_out, info, meta, n)
    dropped = 1.0 - torch.mean(meta[3].float())
    return y, dropped


# Serving-layer decode fast path: the engine (repro_torch.serving) installs a
# provider while it runs; a provider that claims a call returns y, one that
# declines returns None and the regular sort path runs. Inference only.
_DECODE_PROVIDER = None


def set_decode_provider(fn) -> None:
    """Install (or with ``None`` remove) the decode fast-path provider:
    ``fn(params, xf, cfg, info, e) -> Optional[y]``."""
    global _DECODE_PROVIDER
    _DECODE_PROVIDER = fn


def expert_mlp(params: Dict, xf: torch.Tensor, cfg: FFNConfig,
               info: SelectionInfo, e: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planned execution of one MoE layer's expert MLP at a fixed selection,
    by ``cfg.dispatch``: "sort" (dropless, the kernels' path) or "einsum"
    (capacity). Returns (y (N, d), dropped fraction)."""
    if cfg.dispatch == "shard_map":
        raise NotImplementedError(
            "dispatch='shard_map' (expert parallelism over a device mesh) is "
            "not ported yet (ROADMAP queue 1 item 8)")
    if cfg.dispatch != "sort":
        return _einsum_path(params, xf, cfg, info, e)
    zero = torch.zeros((), device=xf.device)
    if _DECODE_PROVIDER is not None:
        y = _DECODE_PROVIDER(params, xf, cfg, info, e)
        if y is not None:
            return y, zero
    return _sort_path(params, xf, cfg, info, e), zero
