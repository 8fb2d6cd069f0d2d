"""Plan invariants of ``CvmmPlan``, ``GatherPlan`` and ``DedupGatherPlan``
(the reference's ``analysis/plans.py``).

The kernels trust their plans: ``row_src`` names the row behind each slot,
``tile_expert`` the weight block of each 128-row tile, ``sel_pos`` the
compacted row of each selection. A wrong plan does not crash; it computes
with the wrong rows. This pass is the oracle for plan soundness, and
``ops.plan_dma_stats(verify=True)`` calls the same ``verify_plan``.

``verify_plan`` proves what a plan must hold without its routing:

  CvmmPlan         ``perm`` a permutation, ``group_sizes`` summing to the
                   rows, ``tile_expert`` non-decreasing within [0, E),
                   ``new_pos`` injective into the slots (no two rows share
                   one), tile purity (each row's slot lies in a tile of its
                   expert), the sentinel N on every slack slot and a real
                   row on every other, zero gates on slack slots;
  GatherPlan       real slots a prefix, slack tokens and weights inert;
  DedupGatherPlan  the real rows a sorted, unique prefix, ``sel_pos``
                   pointing at real rows and at each of them.

``check_plans`` sweeps the builders over adversarial routings (skewed,
empty experts, fewer rows than a tile, colliding selections) and the
decode skeleton's assembled plans, and also holds each plan's integer
fields to the sort they come from (``perm``, ``group_sizes``, the
routed row and gate of each slot, the dedup union and ``sel_pos``).

The reference also replays each plan's DMA chunk table. The port's plans
have none (the Hopper kernels read ``row_src`` directly: ``ops.CvmmPlan``),
so there is no chunk replay here.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..kernels import ops
from .report import Finding

TM = ops.TM


def _bad(check: str, location: str, detail: str) -> Finding:
    return Finding("plans", check, location, detail)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _verify_cvmm_plan(plan: ops.CvmmPlan, n_rows: int,
                      location: str) -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    perm, gs, new_pos = _np(plan.perm), _np(plan.group_sizes), _np(plan.new_pos)
    te, rs = _np(plan.tile_expert), _np(plan.row_src)
    m, e, m_pad = perm.shape[0], gs.shape[0], rs.shape[0]
    if not np.array_equal(np.sort(perm), np.arange(m)):
        findings.append(_bad("perm", location, "perm is not a permutation of the rows"))
    if int(gs.sum()) != m or np.any(gs < 0):
        findings.append(_bad("group-sizes", location,
                             f"group_sizes sums to {int(gs.sum())}, expected {m} "
                             f"non-negative rows"))
    if te.shape != (m_pad // TM,) or np.any(np.diff(te) < 0) or np.any(te < 0) \
            or np.any(te >= e):
        findings.append(_bad("tile-expert", location,
                             f"tile_expert must be {m_pad // TM} entries non-decreasing "
                             f"within [0, {e}), got {te.tolist()}"))
    slots_ok = (np.unique(new_pos).shape[0] == m and not np.any(new_pos < 0)
                and not np.any(new_pos >= m_pad))
    if not slots_ok:
        findings.append(_bad("slots-injective", location,
                             "new_pos does not give every row a slot of its own "
                             "within the padded layout"))
    elif te.shape == (m_pad // TM,) and int(gs.sum()) == m and np.all(gs >= 0):
        # each row's slot must lie in a tile of its expert, or the kernel
        # multiplies it with another expert's weights
        row_e = np.repeat(np.arange(e), gs)
        slot_e = te[new_pos // TM]
        wrong = np.nonzero(slot_e != row_e)[0]
        if wrong.size:
            findings.append(_bad(
                "tile-purity", location,
                f"{wrong.size} row(s) placed in a tile of another expert, e.g. row "
                f"{int(wrong[0])} (expert {int(row_e[wrong[0]])}) in a tile of expert "
                f"{int(slot_e[wrong[0]])}"))
    slack = np.ones((m_pad,), bool)
    if slots_ok:
        slack[new_pos] = False
    if np.any(rs[slack] != n_rows):
        bad = np.nonzero(slack & (rs != n_rows))[0]
        findings.append(_bad("sentinel", location,
                             f"slack slots must hold the sentinel {n_rows}, slot "
                             f"{int(bad[0])} holds {int(rs[bad[0]])}"))
    if np.any((rs[~slack] < 0) | (rs[~slack] >= n_rows)):
        findings.append(_bad("row-src", location,
                             f"a routed slot names a row outside [0, {n_rows})"))
    if plan.gate_tiles is not None:
        gates = _np(plan.gate_tiles).reshape(-1)
        if gates.shape != (m_pad,) or np.any(gates[slack] != 0.0):
            findings.append(_bad("gate-slack", location,
                                 "gate_tiles must be exactly 0 on slack slots (that zero "
                                 "is what drops a slack row's output)"))
    return findings, 8


def _verify_gather_plan(plan: ops.GatherPlan, n_rows: int,
                        location: str) -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    rs, tok = _np(plan.row_src), _np(plan.tok_src)
    w = _np(plan.weight_tiles).reshape(-1)
    valid = rs < n_rows
    m = int(valid.sum())
    if np.any(valid != (np.arange(rs.shape[0]) < m)) or np.any(rs < 0):
        findings.append(_bad("slack-layout", location,
                             "GatherPlan keeps flat selection order: real slots must "
                             "form the prefix, sentinel slack the tail"))
    if np.any(valid) and np.any(tok[~valid] <= tok[valid].max()):
        findings.append(_bad("tok-slack", location,
                             "slack slots carry a real destination token"))
    if np.any(w[~valid] != 0.0):
        findings.append(_bad("weight-slack", location, "weight_tiles must be 0 on slack slots"))
    return findings, 3


def _verify_dedup_plan(plan: ops.DedupGatherPlan, n_rows: int,
                       location: str) -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    rs, sel = _np(plan.row_src), _np(plan.sel_pos)
    valid = rs < n_rows
    u = int(valid.sum())
    if np.any(valid != (np.arange(rs.shape[0]) < u)) or np.any(rs < 0):
        findings.append(_bad("slack-layout", location,
                             "dedup row_src must keep the real rows a contiguous prefix "
                             "(sentinels last)"))
    if u and np.any(np.diff(rs[:u]) <= 0):
        findings.append(_bad("sorted-unique", location,
                             "dedup row_src's prefix must be strictly ascending"))
    if np.any(sel < 0) or np.any(sel >= rs.shape[0]) or (sel.size and np.any(~valid[sel])):
        findings.append(_bad("sel-pos-range", location,
                             "sel_pos must map every selection to a real compacted row, "
                             "never to sentinel slack"))
    elif u and not np.array_equal(np.unique(sel), np.arange(u)):
        findings.append(_bad("sel-pos-surjective", location,
                             "every compacted row must be selected at least once: an "
                             "unselected row is read for nothing"))
    return findings, 4


def verify_plan(plan, n_rows: int, location: str = "") -> List[Finding]:
    """Every invariant of one plan that holds without its routing; empty
    when the plan is sound. ``check_plans`` adds the routing checks."""
    location = location or type(plan).__name__
    if isinstance(plan, ops.CvmmPlan):
        return _verify_cvmm_plan(plan, n_rows, location)[0]
    if isinstance(plan, ops.GatherPlan):
        return _verify_gather_plan(plan, n_rows, location)[0]
    if isinstance(plan, ops.DedupGatherPlan):
        return _verify_dedup_plan(plan, n_rows, location)[0]
    raise TypeError(f"verify_plan: not a plan: {type(plan).__name__}")


def check_routing(plan: ops.CvmmPlan, idx: np.ndarray, gates, location: str) -> List[Finding]:
    """A CvmmPlan against the routing it was built from: ``perm`` the stable
    sort of the flat expert ids, ``group_sizes`` their counts, each slot's
    row and gate those of its sorted selection."""
    findings: List[Finding] = []
    n, k = idx.shape
    e_flat = idx.reshape(-1)
    perm, new_pos = _np(plan.perm), _np(plan.new_pos)
    e = _np(plan.group_sizes).shape[0]
    if not np.array_equal(perm, np.argsort(e_flat, kind="stable")):
        findings.append(_bad("perm-sort", location,
                             "perm is not the stable sort of the selected experts"))
    if not np.array_equal(_np(plan.group_sizes), np.bincount(e_flat, minlength=e)):
        findings.append(_bad("group-sizes-sort", location,
                             "group_sizes differ from the counts of the selected experts"))
    if perm.shape == (n * k,) and new_pos.shape == (n * k,):
        tok = np.repeat(np.arange(n), k)
        if not np.array_equal(_np(plan.row_src)[new_pos], tok[perm]):
            findings.append(_bad("routing", location,
                                 "row_src[new_pos] is not the token of the sorted selection"))
        if gates is not None and plan.gate_tiles is not None:
            want = np.zeros((plan.m_pad,), np.float32)
            want[new_pos] = gates.reshape(-1)[perm]
            if not np.allclose(_np(plan.gate_tiles).reshape(-1), want):
                findings.append(_bad("gates", location,
                                     "gate_tiles disagree with the routed gates"))
    return findings


# (name, n_tokens, n_experts, k, style)
_MOE_CASES = (("moe-random", 100, 6, 3, "random"), ("moe-skewed", 300, 3, 2, "skewed"),
              ("moe-empty-experts", 57, 5, 2, "subset"), ("moe-subtile", 8, 4, 2, "random"),
              ("moe-k1", 130, 2, 1, "random"), ("moe-47m-layer", 512, 16, 4, "random"))
# (name, n_tokens, n_rows, s)
_GATHER_CASES = (("gather-random", 40, 300, 4), ("gather-colliding", 100, 64, 8),
                 ("gather-sparse", 5, 1000, 3), ("gather-subtile", 3, 50, 2))
# (name, n_tokens, k, n_experts): serving's decode shape classes, and
# granite-moe's top-8 of 40 at the three batch sizes of the tests
_DECODE_CASES = (("decode-b4", 4, 2, 4), ("decode-b8", 8, 2, 4), ("decode-b1-k1", 1, 1, 2),
                 ("decode-b2-e8", 2, 2, 8), ("decode-granite-n1", 1, 8, 40),
                 ("decode-granite-n8", 8, 8, 40), ("decode-granite-n32", 32, 8, 40))


def _topk_idx(rng, n: int, e: int, k: int) -> np.ndarray:
    """Distinct experts a token, as a router's top-k picks them."""
    return np.argsort(rng.rand(n, e), axis=1)[:, :k].astype(np.int64)


def check_plans() -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    checks = 0
    rng = np.random.RandomState(0)

    for name, n, e, k, style in _MOE_CASES:
        if style == "skewed":
            idx = np.zeros((n, k), np.int64)
        elif style == "subset":
            idx = rng.randint(0, max(e - 2, 1), size=(n, k)).astype(np.int64)
        else:
            idx = rng.randint(0, e, size=(n, k)).astype(np.int64)
        gates = rng.rand(n, k).astype(np.float32)
        plan = ops.make_moe_plan(torch.from_numpy(idx), e, torch.from_numpy(gates))
        findings += verify_plan(plan, n, name)
        findings += check_routing(plan, idx, gates, name)
        checks += 12

    for name, n, rows, s in _GATHER_CASES:
        idx = rng.randint(0, rows, size=(n, s)).astype(np.int64)
        w = torch.from_numpy(rng.rand(n, s).astype(np.float32))
        gplan = ops.make_gather_plan(torch.from_numpy(idx), w, rows)
        findings += verify_plan(gplan, rows, name)
        if not np.array_equal(_np(gplan.row_src)[:n * s], idx.reshape(-1)):
            findings.append(_bad("routing", name, "GatherPlan row_src prefix != flat idx"))
        checks += 4
        dname = name.replace("gather", "dedup")
        dplan = ops.make_dedup_gather_plan(torch.from_numpy(idx), w, rows)
        findings += verify_plan(dplan, rows, dname)
        union = np.unique(idx)
        if not np.array_equal(_np(dplan.row_src)[:union.size], union):
            findings.append(_bad("dedup-union", dname,
                                 "the compacted rows are not the sorted union of the "
                                 "selected rows"))
        if not np.array_equal(_np(dplan.row_src)[_np(dplan.sel_pos)], idx.reshape(-1)):
            findings.append(_bad("sel-pos", dname,
                                 "row_src[sel_pos] must give back the flat selection"))
        if not np.array_equal(_np(dplan.tok_src), np.repeat(np.arange(n), s)):
            findings.append(_bad("tok-src", dname, "dedup tok_src != the selections' tokens"))
        checks += 7

    # Decode skeletons: for any routing the cached layout must assemble into
    # a plan that passes the same oracle as every per-call plan.
    for name, n, k, e in _DECODE_CASES:
        skel = ops.make_decode_plan(n, k, e, device="cpu")
        findings += verify_plan(skel.gather, n, f"{name}/gather")
        te_want = np.repeat(np.arange(e), skel.cap // TM)
        if not np.array_equal(_np(skel.tile_expert), te_want):
            findings.append(_bad("decode-tile-expert", name,
                                 "skeleton tile_expert != repeat(arange(e), cap // TM): "
                                 "the static layout is what makes the cache routing-free"))
        checks += 5
        idx = _topk_idx(rng, n, e, k)
        gates = rng.rand(n, k).astype(np.float32)
        full = ops.assemble_decode_plan(skel, torch.from_numpy(idx), torch.from_numpy(gates))
        findings += verify_plan(full, n, name)
        findings += check_routing(full, idx, gates, name)
        if not np.array_equal(_np(full.tile_expert), _np(skel.tile_expert)):
            findings.append(_bad("decode-tile-drift", name,
                                 "the assembled plan's tile_expert differs from the "
                                 "skeleton's"))
        slots = _np(ops.decode_slots(skel, torch.from_numpy(idx)))
        if not np.array_equal(np.sort(_np(full.new_pos)), np.sort(slots)):
            findings.append(_bad("decode-slots", name,
                                 "decode_slots and the assembled new_pos place the "
                                 "selections in different slots"))
        checks += 14
    return findings, checks
