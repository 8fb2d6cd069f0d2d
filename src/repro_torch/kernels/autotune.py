"""Launch-schedule autotuner with a persistent on-disk cache (the
reference's ``kernels/autotune.py``, over the port's own schedules).

Every hand-written kernel takes a launch schedule that its wrapper works out
from the call's shapes and the card's SM count. This module is the one place
those choices come from, in four families:

  ``row_gemm``     K1, K2, K4: the item width BN of the persistent row-tile
                   GEMM (``cvmm.row_gemm_schedule``);
  ``dw_split``     K3, K5: the chunk of an expert's tiles one block sums
                   (``cvmm.dw_chunk``, ``cvmm.dw_split``);
  ``gather_rows``  K6: rows a block and 16-byte vectors a lane
                   (``cvmm.gather_rows_schedule``);
  ``flash``        K7 in bf16 (the float32 body does not split): the key
                   splits of an item (``flash_attention.flash_schedule``).

heuristic (tuning off, the default)
    Each family's fixed formula in shapes and the SM count, the one the
    wrappers used before this module existed, with no I/O and no
    measurement, so every launch is the same as without a tuner.

tuned (``REPRO_TORCH_AUTOTUNE=1`` or ``autotune.enable()``)
    The legal candidates of a shape (every schedule the CUDA sources
    instantiate and the call allows, within the shared memory a block may
    opt in to, as ``analysis/smem.py`` itemises it) are ranked by a
    roofline cost on the device's ``Hardware`` model
    (``roofline/analysis.py``) plus a fixed cost per block and per wave;
    the first ``TUNE_TOP_K`` and the heuristic's schedule are launched on
    the card, in the very variant the call runs, and timed with CUDA events,
    the device alone (``WARMUP`` calls, then the least of ``BENCH_ITERS``
    samples of ``BENCH_CALLS`` calls each, queued while the device sleeps).
    The fastest is kept, in memory for the process and in the cache file,
    if it beats the heuristic's by ``SWITCH_MARGIN``; else the heuristic's
    is. A kernel that fails to build or launch while it is timed raises;
    nothing falls back to the heuristic and nothing times a plain version:
    without a card the tuner answers with the heuristic (tests inject
    timings with ``set_benchmark_override``).

Keys
----
K1-K6 are keyed on their exact shape and timed at it, on a layout like a
training plan's (or a decode skeleton's) built for that M_pad: a plan's
M_pad is fixed by the batch's shape (``ops.plan_m_pad``), not by its
routing, so a training run or a server meets few shapes, each tuned once.
A prefill chunk moves K7's key count with every offset, so K7 keys on its
batch, query and head widths and the power of two nearest its longest
item's key tiles, is timed with its keys set to that many tiles, and its
splits are then cut to what the exact call allows.

Some decisions change the bits: K3's and K5's chunk and K7's splits set the
order of float32 sums (BN does not). A decision is made once per key and
then read from memory, so a process gets the same bits on every call.
Timing never runs inside a CUDA-graph capture or a profiler's region:
there a cache miss raises, naming the way out (warm the cache first).

Cache layout
------------
``<cache_dir>/<backend>.json``, ``cache_dir`` being
``$REPRO_TORCH_AUTOTUNE_CACHE`` or ``~/.cache/repro_torch/autotune``, in the
reference's schema::

    {"schema": 1, "backend": "cuda", "hardware": "nvidia_h100_sxm",
     "entries": {"<family>|<dim>=<val>|...": {
         "tiles": {"bn": 128}, "provenance": "tuned", "us": 12.3,
         "estimate_s": ..., "run_class": "..."}}}

Writers merge with what is on disk and publish with ``os.replace``. An
unreadable file, another schema or another card's file, and an entry whose
tiles are no longer a legal candidate (a smaller budget) are dropped and
tuned again, never raised on. ``STATS["microbench_calls"]`` counts the
candidates timed: a warm cache makes none.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from ..analysis import smem as S
from ..roofline.analysis import Hardware, hardware_for
from . import cvmm as K
from . import flash_attention as K7

TM = K.TM
SCHEMA_VERSION = 1
DEFAULT_CACHE_DIR = "~/.cache/repro_torch/autotune"
TUNE_TOP_K = 3                # candidates timed after the roofline ranking
WARMUP = 2                    # calls before the clock (the first builds the kernel)
BENCH_ITERS = 5               # timed samples; the least counts
BENCH_CALLS = 10              # back-to-back calls a sample: a 20 us kernel alone
                              # is within the events' own jitter
SLEEP_CYCLES = 4_000_000      # the device's wait (~2 ms) while the host queues a sample
SWITCH_MARGIN = 0.03          # a schedule replaces the heuristic's only when this much
                              # faster: near-ties are within the timings' noise
BLOCK_OVERHEAD_S = 2e-6       # a block's fixed cost: its ring's first fill, its epilogue
WAVE_OVERHEAD_S = 3e-6        # a wave's: blocks starting and draining together

# The schedules the CUDA sources instantiate: the candidates read these,
# tests/test_torch_autotune.py holds them to the sources and
# analysis/smem.py itemises the shared memory of every instance they name.
ROW_GEMM_WIDTHS = {(False, False): (256, 128, 64),   # csrc/row_gemm.cuh with_bn,
                   (False, True): (128, 64),         # keyed (GLU, save_preact)
                   (True, False): (64,), (True, True): (64,)}
GATHER_ROWS = (8, 4, 2, 1)                           # csrc/gather_rows.cu
GATHER_VPL = (1, 2, 4)
DW_CHUNKS = tuple(range(1, 9))                       # any chunk; 1-8 are offered
FLASH_BK = (64, 128)                                 # csrc/flash_attention.cu

STATS = {"microbench_calls": 0, "cache_hits": 0, "tuned": 0, "cache_invalid": 0,
         "timed_launches": 0}

_ENABLED: Optional[bool] = None               # None: read $REPRO_TORCH_AUTOTUNE
_MEM_CACHE: Dict[str, Dict[str, Any]] = {}    # cache path -> loaded file
_BENCH_OVERRIDE: Optional[Callable] = None    # tests: fn(family, shape, tiles) -> us


class TileDecision(NamedTuple):
    tiles: Optional[Dict[str, int]]   # None: no legal candidate
    provenance: str                   # "heuristic" | "tuned" | "none"


# ---------------------------------------------------------------------------
# Tuner state
# ---------------------------------------------------------------------------

def enabled() -> bool:
    if _ENABLED is not None:
        return _ENABLED
    return os.environ.get("REPRO_TORCH_AUTOTUNE", "") not in ("", "0", "false")


def enable(on: Optional[bool] = True) -> None:
    """Force tuning on or off for this process; ``enable(None)`` reads
    ``REPRO_TORCH_AUTOTUNE`` again."""
    global _ENABLED
    _ENABLED = on


def reset(*, memory_only: bool = False) -> None:
    """Drop the in-memory copy of the cache files; unless ``memory_only``,
    zero STATS too."""
    _MEM_CACHE.clear()
    if not memory_only:
        for key in STATS:
            STATS[key] = 0


def set_benchmark_override(fn: Optional[Callable]) -> None:
    """Tests: time candidates with ``fn(family, shape, tiles) -> us``
    instead of the card; ``microbench_calls`` still counts each."""
    global _BENCH_OVERRIDE
    _BENCH_OVERRIDE = fn


def default_smem_budget(hw: Optional[Hardware] = None) -> int:
    """Bytes of shared memory a candidate may take (dynamic and static):
    the card's opt-in limit."""
    return int((hw or hardware_for()).smem_block_bytes)


def cache_path(backend: str = "cuda") -> str:
    root = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE") or DEFAULT_CACHE_DIR
    return os.path.join(os.path.expanduser(root), f"{backend}.json")


def smem_bytes(family: str, shape: Dict[str, int], tiles: Dict[str, int]) -> int:
    """Shared memory (dynamic and static) of one bf16 launch of ``family``,
    from ``analysis/smem.py``'s inventory, which ``chip_smoke.py`` holds to
    what each launcher requests on the card."""
    return sum(S.launch_bytes(*S.launch_instance(family, shape, tiles)))


# ---------------------------------------------------------------------------
# The families: heuristic, candidates, key, cost, measurement
# ---------------------------------------------------------------------------

def _occupancy(blocks: int, hw: Hardware) -> float:
    return min(1.0, blocks / hw.n_sms)


def _bench_dtype(b: int):
    return torch.bfloat16 if b == 2 else torch.float32


def _bench_plan(m_pad: int, n_experts: int, gen, dev):
    """(rows, row_src, tile_expert, gate) of a layout like the call's: a
    training plan (``ops.make_moe_plan`` of the m_pad - E x 128 rows that
    fill ``m_pad``, each to a random expert: uneven segments, slack rows
    and the spare tiles at the end), or, where m_pad holds no more than a
    tile an expert (a decode skeleton), ``m_pad`` rows in equal segments."""
    rows = m_pad - n_experts * TM
    if rows >= TM:
        from . import ops
        idx = torch.randint(n_experts, (rows, 1), generator=gen, device=dev)
        plan = ops.make_moe_plan(idx, n_experts, torch.rand((rows, 1), generator=gen,
                                                             device=dev))
        return rows, plan.row_src, plan.tile_expert, plan.gate_tiles.reshape(-1)
    t = torch.arange(m_pad // TM, device=dev, dtype=torch.int64)
    te = (t * n_experts // (m_pad // TM)).to(torch.int32)
    rs = torch.randperm(m_pad, generator=gen, device=dev).to(torch.int32)
    return m_pad, rs, te, torch.rand((m_pad,), generator=gen, device=dev)


def _exact(shape) -> Dict[str, int]:
    """The key of a shape tuned as it is: every width but the SM count,
    which the cache file's card fixes."""
    return {key: v if isinstance(v, str) else int(v)
            for key, v in shape.items() if key != "sms"}


def _as_is(shape, dims, hw) -> Dict[str, int]:
    return shape


# ----------------------------------------------------------- row_gemm (K1, K2, K4)

def _heur_row_gemm(shape) -> Dict[str, int]:
    """Items as wide as the call allows (256 columns, or 128 with
    save_preact or a reduction shallower than ``cvmm.ROW_GEMM_WIDE_MIN_K``,
    64 with GLU) while every SM still gets ``cvmm.ROW_GEMM_MIN_ITEMS_PER_SM``
    items; else the next narrower width, down to 64 (cvmm.py says why)."""
    n_tiles, n_pad = shape["m_pad"] // TM, shape["n_pad"]
    shallow = shape["k_pad"] < K.ROW_GEMM_WIDE_MIN_K
    widest = 64 if shape["glu"] else 128 if shape["save"] or shallow else 256
    for width in (256, 128):
        if (width <= widest and n_pad % width == 0
                and n_tiles * (n_pad // width) >= K.ROW_GEMM_MIN_ITEMS_PER_SM * shape["sms"]):
            return {"bn": width}
    return {"bn": 64}


def _cand_row_gemm(shape, budget) -> List[Dict[str, int]]:
    heur = _heur_row_gemm(shape)
    if shape["b"] != 2:          # the float32 body has one fixed tile
        return [heur]
    widths = ROW_GEMM_WIDTHS[(bool(shape["glu"]), bool(shape["save"]))]
    out = [{"bn": bn} for bn in widths if shape["n_pad"] % bn == 0
           and smem_bytes("row_gemm", shape, {"bn": bn}) <= budget]
    return sorted(out, key=lambda t: t != heur)


def _cost_row_gemm(shape, tiles, hw) -> float:
    m_pad, k, n, b, bn = shape["m_pad"], shape["k_pad"], shape["n_pad"], shape["b"], tiles["bn"]
    nw = 2 if shape["glu"] else 1
    items = m_pad // TM * (n // bn)
    grid = min(items, hw.n_sms)
    moved = items * (TM * k * b + nw * k * bn * b) + m_pad * n * b
    ops = 2 * m_pad * k * n * nw
    return (max(moved / hw.hbm_bw, ops / hw.peak(b)) / _occupancy(grid, hw)
            + math.ceil(items / grid) * BLOCK_OVERHEAD_S)


def _bench_row_gemm(shape, tiles, dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(0)
    dt = _bench_dtype(shape["b"])
    m_pad, k, n, n_experts = shape["m_pad"], shape["k_pad"], shape["n_pad"], shape["n_experts"]
    rows, rs, te, gate = _bench_plan(m_pad, n_experts, gen, dev)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev).to(dt)

    w = rnd(n_experts, k, n)
    if shape["kernel"] == "cvmm":
        x = rnd(m_pad, k)
        return _time_us(lambda: K.cvmm(x, te, w, bn=tiles["bn"]))
    if shape["kernel"] == "fused_w2":
        u = rnd(m_pad, k)
        return _time_us(lambda: K.fused_w2(u, te, w, gate, bn=tiles["bn"]))
    x = rnd(rows, k)
    wg = rnd(n_experts, k, n) if shape["glu"] else None
    return _time_us(lambda: K.fused_w1(x, rs, te, w, wg, act="relu",
                                       save_preact=bool(shape["save"]), bn=tiles["bn"]))


# ------------------------------------------------------------- dw_split (K3, K5)

def _heur_dw(shape) -> Dict[str, int]:
    return {"chunk": K.DW_CHUNK}


def _cand_dw(shape, budget) -> List[Dict[str, int]]:
    if shape["b"] == 2 and smem_bytes("dw_split", shape, {}) > budget:
        return []
    heur = _heur_dw(shape)
    return sorted(({"chunk": c} for c in DW_CHUNKS), key=lambda t: t != heur)


def _cost_dw(shape, tiles, hw) -> float:
    m_tiles, k, n, b = shape["m_pad"] // TM, shape["k_pad"], shape["n_pad"], shape["b"]
    items, slots = K.dw_split(m_tiles, shape["n_experts"], tiles["chunk"])
    blocks = items * (k // 128) * (n // 128)
    chunks = slots // 2
    moved = chunks * (k // 128) * (n // 128) * tiles["chunk"] * TM * 256 * b
    combine = max(0, chunks - shape["n_experts"]) * k * n * 4 * 2
    ops = 2 * m_tiles * TM * k * n
    return (max((moved + combine) / hw.hbm_bw, ops / hw.peak(b)) / _occupancy(blocks, hw)
            + math.ceil(blocks / hw.n_sms) * WAVE_OVERHEAD_S
            + blocks / hw.n_sms * BLOCK_OVERHEAD_S)


def _bench_dw(shape, tiles, dev) -> float:
    """The call's own variant: K5, or K3 with x gathered (dW1) or with g
    gathered and, when the call has one, the gate (dW2)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    dt = _bench_dtype(shape["b"])
    m_pad, k, n, e = shape["m_pad"], shape["k_pad"], shape["n_pad"], shape["n_experts"]
    rows, rs, te, gate = _bench_plan(m_pad, e, gen, dev)
    sx = bool(shape["stream_x"]) and shape["kernel"] == "dw_streamed"
    x = torch.randn((rows if sx else m_pad, k), generator=gen, device=dev).to(dt)
    g = torch.randn((m_pad if sx or shape["kernel"] == "cvmm_dw" else rows, n),
                    generator=gen, device=dev).to(dt)
    if shape["kernel"] == "cvmm_dw":
        return _time_us(lambda: K.cvmm_dw(x, te, g, e, chunk=tiles["chunk"]))
    gate = gate if shape["gated"] else None
    return _time_us(lambda: K.dw_streamed(x, g, rs, te, e, stream_x=sx, gate=gate,
                                          chunk=tiles["chunk"]))


# ------------------------------------------------------------------ gather_rows (K6)

def _heur_gather(shape) -> Dict[str, int]:
    """The widest of 8, 4, 2 rows a block that still gives every SM a
    block, else 1; ``cvmm.GATHER_ROWS_VPL`` vectors a lane, or 1 for a
    row of at most 32 vectors (cvmm.py says why)."""
    nvec = shape["row_bytes"] // 16
    vpl = K.GATHER_ROWS_VPL if nvec > 32 else 1
    slices = -(-nvec // (32 * vpl))
    for rows in (8, 4, 2):
        if shape["m_pad"] // rows * slices >= shape["sms"]:
            return {"rows": rows, "vpl": vpl}
    return {"rows": 1, "vpl": vpl}


def _cand_gather(shape, budget) -> List[Dict[str, int]]:
    heur = _heur_gather(shape)
    nvec = shape["row_bytes"] // 16
    out = [{"rows": r, "vpl": v} for r in GATHER_ROWS for v in GATHER_VPL
           if -(-nvec // (32 * v)) <= 65535]          # grid.y's limit
    return sorted(out, key=lambda t: t != heur)


def _cost_gather(shape, tiles, hw) -> float:
    nvec = shape["row_bytes"] // 16
    slices = -(-nvec // (32 * tiles["vpl"]))
    blocks = shape["m_pad"] // tiles["rows"] * slices
    warps = shape["m_pad"] * slices
    moved = 2 * shape["m_pad"] * shape["row_bytes"]
    # up to 64 warps an SM; loads in flight per warp grow with vectors a lane
    inflight = min(1.0, warps * tiles["vpl"] / (hw.n_sms * 64))
    return moved / hw.hbm_bw / inflight + blocks / hw.n_sms * BLOCK_OVERHEAD_S / 8


def _bench_gather(shape, tiles, dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(0)
    m_pad = shape["m_pad"]
    x = torch.randn((m_pad, shape["row_bytes"] // 2), generator=gen,
                    device=dev).to(torch.bfloat16)
    rs = torch.randperm(m_pad, generator=gen, device=dev).to(torch.int32)
    return _time_us(lambda: K.gather_rows(x, rs, schedule=(tiles["rows"], tiles["vpl"])))


# ------------------------------------------------------------------------ flash (K7)

def _flash_longest(shape) -> int:
    grp = shape["h"] // shape["kvh"]
    n_rt = -(-shape["sq"] * grp // K7.ROW_TILE)
    return K7.flash_item_tiles(n_rt - 1, shape["sq"], shape["sk"], grp, bool(shape["causal"]),
                               shape["q_offset"], shape["bk"])


def _flash_items(shape) -> int:
    grp = shape["h"] // shape["kvh"]
    return shape["b"] * shape["kvh"] * -(-shape["sq"] * grp // K7.ROW_TILE)


def _heur_flash(shape) -> Dict[str, int]:
    """The most splits with items x splits at most one block an SM, and no
    more than the longest item's tiles // ``MIN_TILES`` (at least one)."""
    splits = min(_flash_longest(shape) // K7.MIN_TILES, shape["sms"] // _flash_items(shape))
    return {"splits": max(1, splits)}


def _cand_flash(shape, budget) -> List[Dict[str, int]]:
    heur = _heur_flash(shape)
    if smem_bytes("flash", shape, heur) > budget:
        return []
    top = max(1, _flash_longest(shape) // K7.MIN_TILES)
    return sorted(({"splits": s} for s in range(1, top + 1)), key=lambda t: t != heur)


def _bucket(n: int) -> int:
    """The power of two nearest ``n`` on a log scale (at least 1)."""
    return 1 << max(0, round(math.log2(max(int(n), 1))))


def _class_flash(shape) -> Dict[str, int]:
    """The call's batch, query and head widths, and the power of two
    nearest its longest item's key tiles."""
    dims = {key: int(shape[key]) for key in ("b", "sq", "h", "kvh", "d", "bk", "causal")}
    return dict(dims, tiles=_bucket(_flash_longest(shape)))


def _rep_flash(shape, dims, hw) -> Dict[str, int]:
    """The call with its keys cut or grown to ``tiles`` key tiles for the
    longest item (causal: the queries last, so Sk is at least Sq)."""
    sk = dims["tiles"] * dims["bk"]
    if dims["causal"]:
        q_offset = max(0, sk - dims["sq"])
        sk = q_offset + dims["sq"]
    else:
        q_offset = 0
    return dict(shape, sk=sk, q_offset=q_offset, sms=hw.n_sms)


def _fit_flash(shape, tiles) -> Dict[str, int]:
    """A class's splits cut to what the exact call allows."""
    top = max(1, _flash_longest(shape) // K7.MIN_TILES)
    return {"splits": min(tiles["splits"], top)}


def _cost_flash(shape, tiles, hw) -> float:
    items, tiles_n, s = _flash_items(shape), _flash_longest(shape), tiles["splits"]
    blocks = items * s
    ops = 4 * items * K7.ROW_TILE * tiles_n * shape["bk"] * shape["d"]
    merge = (s > 1) * blocks * (shape["d"] // 2 + 4) * K7.SCRATCH_THREADS * 4 * 2
    return (ops / hw.peak(2) / _occupancy(blocks, hw) + merge / hw.hbm_bw
            + math.ceil(blocks / hw.n_sms) * WAVE_OVERHEAD_S)


def _bench_flash(shape, tiles, dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(0)
    b, sq, h, kvh, sk, d = (shape[key] for key in ("b", "sq", "h", "kvh", "sk", "d"))

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = rnd(b, sq, h, d), rnd(b, sk, kvh, d), rnd(b, sk, kvh, d)
    return _time_us(lambda: K7.flash_attention(
        q, k, v, causal=bool(shape["causal"]), scale=d ** -0.5,
        q_offset=shape["q_offset"], splits=tiles["splits"]))


class _Family(NamedTuple):
    heuristic: Callable       # exact shape -> tiles: the formula of tuning off
    candidates: Callable      # (shape, budget) -> legal tiles, heuristic first
    key: Callable             # exact shape -> the cache key's dims
    timed: Callable           # (exact shape, key dims, hw) -> the shape timed
    cost: Callable            # (shape, tiles, hw) -> seconds (ranking only)
    bench: Callable           # (shape, tiles, device) -> measured us
    fit: Callable             # (exact shape, class tiles) -> tiles for the call
    run_class: str


def _same(shape, tiles):
    return dict(tiles)


_FAMILIES: Dict[str, _Family] = {
    "row_gemm": _Family(_heur_row_gemm, _cand_row_gemm, _exact, _as_is,
                        _cost_row_gemm, _bench_row_gemm, _same, "even tiles an expert"),
    "dw_split": _Family(_heur_dw, _cand_dw, _exact, _as_is, _cost_dw, _bench_dw,
                        _same, "even tiles an expert"),
    "gather_rows": _Family(_heur_gather, _cand_gather, _exact, _as_is,
                           _cost_gather, _bench_gather, _same, "permuted rows"),
    "flash": _Family(_heur_flash, _cand_flash, _class_flash, _rep_flash, _cost_flash,
                     _bench_flash, _fit_flash, "one row tile an item"),
}


def families() -> tuple:
    """Every family the tuner decides (the analysis passes sweep these)."""
    return tuple(_FAMILIES)


def heuristic(family: str, shape: Dict[str, int]) -> Dict[str, int]:
    return _FAMILIES[family].heuristic(shape)


def enumerate_candidates(family: str, shape: Dict[str, int], *,
                         budget: Optional[int] = None,
                         tuned: bool = True) -> List[Dict[str, int]]:
    """Every schedule ``decide(family, shape)`` could return: with
    ``tuned`` the full legal list at ``shape`` (heuristic first), else the
    heuristic alone."""
    budget = budget if budget is not None else default_smem_budget()
    cands = _FAMILIES[family].candidates(shape, budget)
    return cands if tuned else cands[:1]


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def _time_us(fn) -> float:
    """Device microseconds a call of ``fn``: the least over ``BENCH_ITERS``
    samples of ``BENCH_CALLS`` back-to-back calls between two CUDA events,
    after ``WARMUP`` calls. The device sleeps while the host queues each
    sample, so the events time the kernels alone: a 20 us kernel's wrapper
    takes about as long on the host, and timing the two together ranked
    the host's noise. A sample whose queuing outlasted the sleep is taken
    again with twice the sleep. An error from the kernel's build or launch
    raises."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    best, taken, sleep = float("inf"), 0, SLEEP_CYCLES
    while taken < BENCH_ITERS:
        slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        slept.record()
        torch.cuda._sleep(sleep)
        start.record()
        t0 = time.perf_counter()
        for _ in range(BENCH_CALLS):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        STATS["timed_launches"] += BENCH_CALLS
        if host_ms >= slept.elapsed_time(start):
            if sleep >= 64 * SLEEP_CYCLES:
                raise RuntimeError(f"autotune: queuing {BENCH_CALLS} calls took {host_ms:.1f} ms, "
                                   f"longer than the device's longest wait")
            sleep *= 2
            continue
        best = min(best, start.elapsed_time(end) * 1e3 / BENCH_CALLS)
        taken += 1
    STATS["timed_launches"] += WARMUP
    return best


def _check_can_time() -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("autotune: a schedule is not in the cache and cannot be timed "
                           "inside a CUDA-graph capture; run the call once before "
                           "capturing (or warm $REPRO_TORCH_AUTOTUNE_CACHE)")
    if torch.autograd.profiler._is_profiler_enabled:
        raise RuntimeError("autotune: a schedule is not in the cache and is not timed "
                           "inside a profiler's region; run the call once before "
                           "profiling (or warm $REPRO_TORCH_AUTOTUNE_CACHE)")


def _measure(family: str, shape, tiles, dev) -> float:
    STATS["microbench_calls"] += 1
    if _BENCH_OVERRIDE is not None:
        return float(_BENCH_OVERRIDE(family, shape, tiles))
    if dev.type != "cuda":
        raise RuntimeError(f"autotune: {family} cannot be timed on {dev}")
    return float(_FAMILIES[family].bench(shape, tiles, dev))


# ---------------------------------------------------------------------------
# Persistent cache
# ---------------------------------------------------------------------------

def _key(family: str, dims: Dict[str, int]) -> str:
    return family + "|" + "|".join(f"{k}={dims[k]}" for k in sorted(dims))


def _fresh_file(backend: str, hw: Hardware) -> Dict[str, Any]:
    return {"schema": SCHEMA_VERSION, "backend": backend, "hardware": hw.name,
            "entries": {}}


def _read_disk(path: str, hw: Hardware) -> Optional[Dict[str, Any]]:
    """The cache file, or None: missing, or dropped as unreadable, of
    another schema or of another card (counted in ``cache_invalid``)."""
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        STATS["cache_invalid"] += 1
        return None
    if not (isinstance(data, dict) and data.get("schema") == SCHEMA_VERSION
            and isinstance(data.get("entries"), dict)
            and data.get("hardware", hw.name) == hw.name):
        STATS["cache_invalid"] += 1
        return None
    return data


def _load_cache(path: str, backend: str, hw: Hardware) -> Dict[str, Any]:
    if path not in _MEM_CACHE:
        _MEM_CACHE[path] = _read_disk(path, hw) or _fresh_file(backend, hw)
    return _MEM_CACHE[path]


def _store(path: str, backend: str, hw: Hardware, key: str, entry: Dict[str, Any]) -> None:
    """Read what is on disk, add the entry, publish by atomic rename:
    concurrent writers each keep their entries, readers never see a torn
    file."""
    data = _read_disk(path, hw) or _fresh_file(backend, hw)
    data["entries"][key] = entry
    folder = os.path.dirname(path)
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, prefix=".tune-", suffix=".json")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(data, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _MEM_CACHE[path] = data


def _entry_tiles(entry, candidates) -> Optional[Dict[str, int]]:
    """An entry counts only while its tiles are still a legal candidate."""
    if not isinstance(entry, dict):
        return None
    tiles = entry.get("tiles")
    if isinstance(tiles, dict) and tiles in candidates:
        return dict(tiles)
    return None


# ---------------------------------------------------------------------------
# The query
# ---------------------------------------------------------------------------

def decide(family: str, shape: Dict[str, int], *, device=None,
           budget: Optional[int] = None) -> TileDecision:
    """One launch's schedule. Tuning off (or no card to time on and no
    override): the heuristic, at no cost. On: the key's entry in memory or
    on disk if still legal, else the top ``TUNE_TOP_K`` candidates by
    roofline cost and the heuristic's timed (at the exact shape; K7 at its
    class's representative) and the winner stored; then fitted to the
    exact call."""
    spec = _FAMILIES[family]
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if not enabled() or (dev.type != "cuda" and _BENCH_OVERRIDE is None):
        return TileDecision(spec.heuristic(shape), "heuristic")
    hw = hardware_for(dev)
    budget = budget if budget is not None else default_smem_budget(hw)
    dims = spec.key(shape)
    rep = spec.timed(shape, dims, hw)
    cands = spec.candidates(rep, budget)
    if not cands:
        return TileDecision(None, "none")
    path = cache_path(dev.type)
    key = _key(family, dims)
    cached = _entry_tiles(_load_cache(path, dev.type, hw)["entries"].get(key), cands)
    if cached is not None:
        STATS["cache_hits"] += 1
        return TileDecision(spec.fit(shape, cached), "tuned")
    ranked = sorted(range(len(cands)), key=lambda i: (spec.cost(rep, cands[i], hw), i))
    # the heuristic's schedule (cands[0]) is always timed, and kept unless
    # another is faster by more than the timings' noise
    survivors = [cands[0]] + [cands[i] for i in ranked[:TUNE_TOP_K] if i != 0]
    best, best_us = survivors[0], None
    if len(survivors) > 1:
        _check_can_time()
        timed = [(_measure(family, rep, tiles, dev), tiles) for tiles in survivors]
        best_us, best = timed[0]
        us, tiles = min(timed[1:], key=lambda t: t[0])
        if best_us - us > SWITCH_MARGIN * abs(best_us):
            best, best_us = tiles, us
    _store(path, dev.type, hw, key, {
        "tiles": best, "provenance": "tuned", "us": best_us,
        "estimate_s": spec.cost(rep, best, hw), "run_class": spec.run_class})
    STATS["tuned"] += 1
    return TileDecision(spec.fit(shape, best), "tuned")
