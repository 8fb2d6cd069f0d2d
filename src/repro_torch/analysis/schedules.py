"""Exact coverage of the port's own work partitions, for every schedule the
tuner can emit (takes the place of the reference's ``analysis/pipeline.py``,
whose DMA rings have no counterpart in the Hopper kernels).

Each kernel splits its work over blocks by a rule that the wrappers and the
sources share; a wrong split does not crash, it drops or doubles work. The
pass replays the port's own partition functions over a shape grid, for
every candidate ``autotune.enumerate_candidates`` gives, and proves:

  row_gemm     ``cvmm.row_gemm_block_items``: every (row tile, column block)
               item walked by exactly one block of the persistent grid, the
               grid at most one block an SM and no block idle;
  dw_split     ``cvmm.dw_split_items`` (csrc/dw_gemm.cuh's ``find_item``):
               every tile in exactly one chunk of its own expert, at most
               ``chunk`` tiles a chunk, each expert's chunks counted right,
               every empty expert given its zeros, and no two partials of
               one output block in the same scratch slot;
  flash        ``flash_attention.flash_split_ranges`` over each item's
               ``flash_item_tiles``: every key tile of every item in exactly
               one split, splits balanced and of at least ``MIN_TILES``
               tiles, and the grid's blocks one per (item, split);
  gather_rows  K6's grid: every (slot, 16-byte vector) copied by exactly one
               lane of one block.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..kernels import autotune
from ..kernels import cvmm as K
from ..kernels import flash_attention as K7
from .report import Finding
from .smem import shape_grid

TM = K.TM


def _bad(check: str, location: str, detail: str) -> Finding:
    return Finding("schedules", check, location, detail)


def _check_row_gemm(shape, tiles, loc) -> List[Finding]:
    m_pad, n_pad, sms = shape["m_pad"], shape["n_pad"], shape["sms"]
    sched = K.row_gemm_schedule(m_pad, shape["k_pad"], n_pad, sms, shape["glu"],
                                shape["save"], bn=tiles["bn"])
    bn, items, grid = sched
    n_cb = n_pad // bn
    seen = np.zeros((m_pad // TM, n_cb), np.int32)
    idle = 0
    for block in range(grid):
        walk = K.row_gemm_block_items(block, n_pad, sched)
        idle += not walk
        for t, col in walk:
            if not (0 <= t < m_pad // TM and 0 <= col < n_pad and col % bn == 0):
                return [_bad("item-range", loc, f"block {block} walks item ({t}, {col}) "
                                                f"outside the {m_pad // TM} x {n_pad} output")]
            seen[t, col // bn] += 1
    out = []
    if items != seen.size or np.any(seen != 1):
        bad = np.argwhere(seen != 1)
        out.append(_bad("coverage", loc,
                        f"{len(bad)} item(s) not walked exactly once, e.g. tile "
                        f"{bad[0][0]}, column {bad[0][1] * bn}" if len(bad) else
                        f"{items} items reported for {seen.size}"))
    if grid > sms or idle:
        out.append(_bad("grid", loc, f"a grid of {grid} blocks on {sms} SMs, {idle} idle"))
    return out


_LAYOUTS = ("even", "skewed", "empty experts", "one expert")


def _tile_expert(layout: str, m_tiles: int, n_experts: int) -> np.ndarray:
    t = np.arange(m_tiles)
    if layout == "even":
        return t * n_experts // m_tiles
    if layout == "skewed":               # expert 0 holds two thirds of the tiles
        return np.where(t < 2 * m_tiles // 3, 0,
                        1 + (t - 2 * m_tiles // 3) * (n_experts - 1) // max(1, m_tiles // 3 + 1))
    if layout == "empty experts":        # every other expert gets none
        return (t * (n_experts // 2) // m_tiles) * 2
    return np.full((m_tiles,), n_experts - 1)


def _check_dw(shape, tiles, loc) -> List[Finding]:
    out: List[Finding] = []
    chunk, e = tiles["chunk"], shape["n_experts"]
    m_tiles = min(shape["m_pad"] // TM, 300)       # the walk does not grow with M
    n_items, n_slots = K.dw_split(m_tiles, e, chunk)
    for layout in _LAYOUTS:
        te = _tile_expert(layout, m_tiles, e)
        first = {int(x): int(np.argmax(te == x)) for x in np.unique(te)}
        last = {int(x): m_tiles - 1 - int(np.argmax(te[::-1] == x)) for x in np.unique(te)}
        where = f"{loc} {layout}"
        items = K.dw_split_items(te.tolist(), e, chunk)
        if len(items) != n_items:
            out.append(_bad("items", where, f"{len(items)} items for dw_split's {n_items}"))
            continue
        seen = np.zeros((m_tiles,), np.int32)
        zeros = set()
        slots = {}
        for q, it in enumerate(items):
            if it is None:
                continue
            ex, t0, t1, k, count, slot = it
            if t0 == t1:
                zeros.add(ex)
                continue
            if t1 - t0 > chunk or np.any(te[t0:t1] != ex):
                out.append(_bad("chunk", where, f"item {q} takes tiles [{t0}, {t1}) "
                                                f"for expert {ex}"))
            seen[t0:t1] += 1
            if count > 1:
                if not 0 <= slot < n_slots or slot in slots:
                    out.append(_bad("slot", where,
                                    f"item {q}'s partial goes to slot {slot}, "
                                    f"{'taken' if slot in slots else 'outside the scratch'}"))
                slots[slot] = q
            want = last[ex] // chunk - first[ex] // chunk + 1
            if count != want:
                out.append(_bad("chunk-count", where, f"expert {ex}: {count} chunks, "
                                                      f"{want} in its tiles"))
        if np.any(seen != 1):
            bad = np.nonzero(seen != 1)[0]
            out.append(_bad("coverage", where, f"{bad.size} tile(s) not summed exactly "
                                               f"once, e.g. tile {bad[0]}"))
        empty = set(range(e)) - set(te.tolist())
        if zeros != empty:
            out.append(_bad("zeros", where, f"experts {sorted(empty)} have no tiles, "
                                            f"zeros written for {sorted(zeros)}"))
    return out


def _check_flash(shape, tiles, loc) -> List[Finding]:
    out: List[Finding] = []
    grp = shape["h"] // shape["kvh"]
    _, items, splits, grid = K7.flash_schedule(
        shape["b"], shape["sq"], shape["h"], shape["kvh"], shape["sk"], shape["q_offset"],
        bool(shape["causal"]), shape["sms"], shape["bk"], d=shape["d"],
        splits=tiles["splits"])
    n_rt = -(-shape["sq"] * grp // K7.ROW_TILE)
    if items != shape["b"] * shape["kvh"] * n_rt or grid != items * splits:
        out.append(_bad("grid", loc, f"{items} items x {splits} splits in a grid of {grid}"))
    for rt in range(n_rt):
        n_tiles = K7.flash_item_tiles(rt, shape["sq"], shape["sk"], grp, bool(shape["causal"]),
                                      shape["q_offset"], shape["bk"])
        runs = K7.flash_split_ranges(n_tiles, splits)
        seen = np.zeros((n_tiles,), np.int32)
        for lo, hi in runs:
            seen[lo:hi] += 1
        sizes = [hi - lo for lo, hi in runs]
        if np.any(seen != 1):
            out.append(_bad("coverage", f"{loc} row tile {rt}",
                            f"{n_tiles} key tiles split {runs}: not each once"))
        if len(runs) != min(splits, max(1, n_tiles // K7.MIN_TILES)) or \
                max(sizes) - min(sizes) > 1 or (len(runs) > 1 and min(sizes) < K7.MIN_TILES):
            out.append(_bad("balance", f"{loc} row tile {rt}",
                            f"{n_tiles} key tiles split into {sizes}"))
    return out


def _check_gather(shape, tiles, loc) -> List[Finding]:
    m_pad = min(shape["m_pad"], 512)
    rows, vpl = tiles["rows"], tiles["vpl"]
    nvec = shape["row_bytes"] // 16
    seen = np.zeros((m_pad, nvec), np.int32)
    for by in range(-(-nvec // (32 * vpl))):
        for i in range(vpl):
            v = by * 32 * vpl + np.arange(32) + 32 * i
            v = v[v < nvec]
            seen[:, v] += 1          # every block x warp: slot = bx * rows + warp
    blocks_x = m_pad // rows
    if blocks_x * rows != m_pad or np.any(seen != 1):
        return [_bad("coverage", loc, f"rows {rows}, vectors a lane {vpl}: not every "
                                      f"(slot, vector) copied once")]
    return []


_CHECKS = {"row_gemm": _check_row_gemm, "dw_split": _check_dw, "flash": _check_flash,
           "gather_rows": _check_gather}


def check_schedules() -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    checks = 0
    for family in autotune.families():
        seen = set()
        for shape in shape_grid(family):
            for tiles in autotune.enumerate_candidates(family, shape, tuned=True):
                # K3's and K5's walk depends on the tile count, experts and chunk only
                key = ((shape["m_pad"], shape["n_experts"], tiles["chunk"])
                       if family == "dw_split" else
                       (tuple(sorted(shape.items())), tuple(sorted(tiles.items()))))
                if family == "row_gemm" and shape["b"] != 2 or key in seen:
                    continue
                seen.add(key)
                findings += _CHECKS[family](shape, tiles, f"{family}{shape} {tiles}")
                checks += 1
    return findings, checks
