"""CVMM kernels on Hopper: the grouped GEMMs (K1, K2, K4), the expert
weight gradients (K3, K5) and the row gather (K6).

Layout contract (shared with kernels/ops.py, as in the reference's
``kernels/cvmm.py``): rows are sorted by expert and each expert's range is
padded to a multiple of the row tile ``TM`` = 128, so every 128-row tile
belongs to exactly one expert. ``row_src`` (M_pad,) names the unsorted row
behind each padded slot; a sentinel (any index outside [0, N); the plans
use N) marks a slack slot, which reads as a zero row.

  ``fused_w1(x, row_src, te, w1, w1g)``  u = act(x[row_src] @ w1[e]) [* (.. @ w1g[e])]
      replaces ``cvmm_fused_w1_pallas``; CUDA source ``csrc/fused_w1.cu``.
  ``fused_w2(u_pad, te, w2, gate)``      y = (u_pad @ w2[e]) * gate, f32 accumulation
      replaces ``cvmm_fused_w2_pallas``; CUDA source ``csrc/fused_w2.cu``.
  ``dw_streamed(x, g, row_src, te, E)``  dW[e] = sum over e's tiles of A^T B, f32
      replaces ``cvmm_dw_streamed_pallas``; CUDA source ``csrc/dw_streamed.cu``.
  ``cvmm(x_pad, tile_expert, w)``        out[t] = x_pad[t] @ w[tile_expert[t]]
      replaces ``cvmm_pallas``; CUDA source ``csrc/cvmm.cu``.
  ``cvmm_dw(x_pad, te, g_pad, E)``       dW[e] = sum over e's tiles of x_pad^T g_pad, f32
      replaces ``cvmm_dw_pallas``; CUDA source ``csrc/cvmm_dw.cu``.
  ``gather_rows(x, row_src, weight)``    out[s] = x[row_src[s]] (* weight[s])
      replaces ``cvmm_gather_rows_pallas``; CUDA source ``csrc/gather_rows.cu``.

In bf16, K1, K2 and K4 are one persistent ``wgmma`` walk over (row tile,
column block) items (``csrc/row_gemm.cuh``; ``row_gemm_schedule`` sizes
it), K3 and K5 one split over each expert's tiles (``csrc/dw_gemm.cuh``;
``dw_split``); K6 spreads its rows over the card (``gather_rows_schedule``).

Each wrapper takes its plain PyTorch version (``*_plain``) only for tensors
on the CPU. For a CUDA tensor it launches the kernel on the current stream,
or raises. A kernel's output has no autograd history, so on CUDA every
wrapper raises when grad mode is on and an input requires grad: gradients
come from the autograd Functions of ``kernels/ops.py``, whose backward
passes launch the kernels themselves (``moe_mlp_fused``: K1, K3, K4;
``cvmm_planned``: K4, K5). ``LAUNCHES`` counts kernel launches per wrapper,
K7's (``kernels/flash_attention.py``) included; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..common import act_fn
from . import build

TM = 128
LANE = 128

# K7 (kernels/flash_attention.py) counts here too, so one reset covers
# every kernel.
LAUNCHES = {"cvmm": 0, "gather_rows": 0, "fused_w1": 0, "fused_w2": 0,
            "dw_streamed": 0, "cvmm_dw": 0, "flash_attention": 0}
ACTIVATIONS = {"identity": 0, "relu": 1, "gelu": 2, "silu": 3}  # csrc/row_gemm.cuh

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_C = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn(lib_name: str, symbol: str, argtypes):
    fn = getattr(build.load(lib_name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _use_plain(t: torch.Tensor) -> bool:
    """The plain version runs for CPU tensors, and only for them."""
    return t.device.type == "cpu"


_GRAD_REMEDY = ("Differentiate through the autograd Functions of kernels/ops.py "
                "(ops.moe_mlp_fused, ops.cvmm_planned, ops.cvmm), whose "
                "backward launches the kernels, or call this wrapper under "
                "torch.no_grad().")


def _check_cuda(name: str, *tensors: Optional[torch.Tensor],
                remedy: str = _GRAD_REMEDY) -> None:
    """Raise unless the tensors can go to a kernel: on one CUDA device,
    contiguous, 16-byte aligned, and not needing a gradient."""
    tensors = [t for t in tensors if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but a kernel's output has no "
            f"autograd history. {remedy}")
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def _launch_status(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


# ---------------------------------------------------------------------------
# K1, K2 and K4's schedule in bf16 (csrc/row_gemm.cuh, row_gemm_wgmma): about
# one persistent block per SM walks the (row tile, column block) items.
# ---------------------------------------------------------------------------

# Items are as wide as the call allows (256 columns, or 128 with save_preact
# or a reduction shallower than ROW_GEMM_WIDE_MIN_K, 64 with GLU, whose two
# products take 64 each) while every SM still gets at least this many; else
# the next narrower width, down to 64. Wide items read fewer bytes from L2
# per operation (serve-long's prefill chunk, K_pad 512 and 1,536); narrow
# ones spread a small grid over more SMs (serving decode's w1: 160 items of
# 128 columns for 132 SMs) and, where an item's mainloop is only two 64-deep
# slices (training's K2, K4 dX and unfused w2 calls, K_pad 128), keep its
# epilogue short: 128-wide items ran those 4-7 % faster than 256-wide ones
# on an H100 (PERF.md). scripts/row_gemm_ab.py --sweep times the widths.
ROW_GEMM_MIN_ITEMS_PER_SM = 2
ROW_GEMM_WIDE_MIN_K = 512


def row_gemm_schedule(m_pad: int, k_pad: int, n_pad: int, n_sms: int,
                      glu: bool = False, save: bool = False) -> Tuple[int, int, int]:
    """(item width BN, items, grid) of one bf16 K1, K2 or K4 call of shape
    (M_pad, K_pad) x (K_pad, N_pad) on a card of ``n_sms`` SMs: items are
    (128-row tile, BN-column block) pairs, item i covering tile i // (N_pad /
    BN) and columns BN * (i % (N_pad / BN)), and the grid is min(items,
    n_sms) persistent blocks (csrc/row_gemm.cuh)."""
    n_tiles = m_pad // TM
    shallow = k_pad < ROW_GEMM_WIDE_MIN_K
    widest = 64 if glu else 128 if save or shallow else 256
    bn = 64
    for width in (256, 128):
        if (width <= widest and n_pad % width == 0
                and n_tiles * (n_pad // width) >= ROW_GEMM_MIN_ITEMS_PER_SM * n_sms):
            bn = width
            break
    items = n_tiles * (n_pad // bn)
    return bn, items, max(1, min(items, n_sms))


def row_gemm_block_items(block: int, n_pad: int, schedule: Tuple[int, int, int]):
    """The (tile, first column) of every item block ``block`` of the grid
    walks, in its order: items block, block + grid, ... (row_gemm_wgmma's
    walk)."""
    bn, items, grid = schedule
    n_cb = n_pad // bn
    return [(i // n_cb, bn * (i % n_cb)) for i in range(block, items, grid)]


_SMS: Dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    """The card's SM count (cudaDevAttrMultiProcessorCount), read once."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


# ---------------------------------------------------------------------------
# K4: grouped GEMM over expert-pure row tiles
# ---------------------------------------------------------------------------

def cvmm_plain(x_pad: torch.Tensor, tile_expert: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``cvmm``: per-tile batched matmul in float32, rounded
    to x's dtype once (the kernel's f32 accumulation)."""
    m_pad, k = x_pad.shape
    xt = x_pad.reshape(m_pad // TM, TM, k).float()
    out = torch.bmm(xt, w[tile_expert.long()].float())
    return out.reshape(m_pad, w.shape[2]).to(x_pad.dtype)


def cvmm(x_pad: torch.Tensor, tile_expert: torch.Tensor,
         w: torch.Tensor) -> torch.Tensor:
    """x_pad (M_pad, K_pad) tile-aligned rows; tile_expert (M_pad//TM,) int32;
    w (E, K_pad, N_pad) in x's dtype. Returns (M_pad, N_pad) in x's dtype."""
    m_pad, k_pad = x_pad.shape
    e, k_w, n_pad = w.shape
    if (k_w != k_pad or m_pad % TM or k_pad % LANE or n_pad % LANE
            or tile_expert.shape != (m_pad // TM,)):
        raise ValueError(f"cvmm: bad shapes x {tuple(x_pad.shape)}, "
                         f"tile_expert {tuple(tile_expert.shape)}, "
                         f"w {tuple(w.shape)}")
    if w.dtype != x_pad.dtype or x_pad.dtype not in _DTYPE_CODE:
        raise ValueError(f"cvmm: dtypes x {x_pad.dtype}, w {w.dtype}; need "
                         "matching float32 or bfloat16")
    if _use_plain(x_pad):
        return cvmm_plain(x_pad, tile_expert, w)
    _check_cuda("cvmm", x_pad, tile_expert, w)
    if tile_expert.dtype != torch.int32:
        raise ValueError("cvmm: tile_expert must be int32")
    out = torch.empty((m_pad, n_pad), dtype=x_pad.dtype, device=x_pad.device)
    bn, _, grid = row_gemm_schedule(m_pad, k_pad, n_pad, _sm_count(x_pad.device))
    fn = _fn("cvmm", "repro_cvmm", [_C] * 4 + [_I] * 7 + [_C])
    rc = fn(x_pad.data_ptr(), tile_expert.data_ptr(), w.data_ptr(),
            out.data_ptr(), m_pad, k_pad, n_pad, e,
            _DTYPE_CODE[x_pad.dtype], bn, grid,
            torch.cuda.current_stream(x_pad.device).cuda_stream)
    _launch_status("cvmm", rc)
    LAUNCHES["cvmm"] += 1
    return out


# ---------------------------------------------------------------------------
# K6: row gather with a sentinel, optionally weighted
# ---------------------------------------------------------------------------

# K6's grid (csrc/gather_rows.cu): blocks of ROWS warps, one output row
# each, every lane moving VPL 16-byte vectors of its row's slice of 32 * VPL.
# ROWS is the widest of 8, 4, 2 that still gives every SM a block, else 1:
# on an H100 the decode gather (128 rows of 192 vectors in bf16) then runs
# 192 blocks of 2 warps, the prefill chunk's (256 rows) 192 of 4.
# scripts/row_gemm_ab.py --k6 times the choices.
GATHER_ROWS_VPL = 2


def gather_rows_schedule(m_pad: int, row_bytes: int, n_sms: int) -> Tuple[int, int]:
    """(rows a block, 16-byte vectors a lane) of one K6 call on a card of
    ``n_sms`` SMs; the grid is (M_pad / rows, ceil(vectors a row / (32 *
    vectors a lane)))."""
    nvec = row_bytes // 16
    vpl = GATHER_ROWS_VPL if nvec > 32 else 1    # a short row: one pass a lane
    slices = -(-nvec // (32 * vpl))
    for rows in (8, 4, 2):
        if m_pad // rows * slices >= n_sms:
            return rows, vpl
    return 1, vpl


def gather_rows_plain(x: torch.Tensor, row_src: torch.Tensor,
                      weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``gather_rows``: index a copy of x with one zero row
    appended, so every sentinel (any index outside [0, N)) reads zeros."""
    n = x.shape[0]
    xz = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    idx = row_src.long()
    out = xz[torch.where((idx >= 0) & (idx < n), idx, n)]
    if weight is not None:
        out = (out.float() * weight[:, None]).to(x.dtype)
    return out


def gather_rows(x: torch.Tensor, row_src: torch.Tensor,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, K_pad); row_src (M_pad,) int32 with a sentinel (any index
    outside [0, N); the plans use N) on slack slots; weight (M_pad,) float32
    or None. Returns (M_pad, K_pad) in x's dtype."""
    n_rows, k_pad = x.shape
    (m_pad,) = row_src.shape
    if m_pad % TM or (k_pad * x.element_size()) % 16:
        raise ValueError(f"gather_rows: bad shapes x {tuple(x.shape)}, "
                         f"row_src {tuple(row_src.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"gather_rows: dtype {x.dtype}; need float32 or "
                         "bfloat16")
    if weight is not None and (weight.shape != (m_pad,)
                               or weight.dtype != torch.float32):
        raise ValueError("gather_rows: weight must be (M_pad,) float32")
    if _use_plain(x):
        return gather_rows_plain(x, row_src, weight)
    _check_cuda("gather_rows", x, row_src, weight)
    if row_src.dtype != torch.int32:
        raise ValueError("gather_rows: row_src must be int32")
    out = torch.empty((m_pad, k_pad), dtype=x.dtype, device=x.device)
    rows, vpl = gather_rows_schedule(m_pad, k_pad * x.element_size(),
                                     _sm_count(x.device))
    fn = _fn("gather_rows", "repro_gather_rows", [_C] * 4 + [_I] * 6 + [_C])
    rc = fn(x.data_ptr(), row_src.data_ptr(),
            None if weight is None else weight.data_ptr(), out.data_ptr(),
            n_rows, m_pad, k_pad, _DTYPE_CODE[x.dtype], rows, vpl,
            torch.cuda.current_stream(x.device).cuda_stream)
    _launch_status("gather_rows", rc)
    LAUNCHES["gather_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# K1: gather-fused grouped GEMM with an activation (and GLU) epilogue
# ---------------------------------------------------------------------------

def _tiles(a: torch.Tensor) -> torch.Tensor:
    """(M_pad, W) -> (M_pad//TM, TM, W) in float32."""
    return a.reshape(a.shape[0] // TM, TM, a.shape[1]).float()


def fused_w1_plain(x: torch.Tensor, row_src: torch.Tensor,
                   tile_expert: torch.Tensor, w1: torch.Tensor,
                   w1g: Optional[torch.Tensor] = None, *, act: str = "relu",
                   save_preact: bool = False):
    """Plain version of ``fused_w1``: gather, per-tile products in float32,
    the activation (and GLU) in float32, each output rounded once."""
    m_pad = row_src.shape[0]
    xt = _tiles(gather_rows_plain(x, row_src))
    te = tile_expert.long()
    h = torch.bmm(xt, w1[te].float()).reshape(m_pad, -1)
    u = act_fn(act)(h)
    hg = None
    if w1g is not None:
        hg = torch.bmm(xt, w1g[te].float()).reshape(m_pad, -1)
        u = u * hg
    if not save_preact:
        return u.to(x.dtype)
    return tuple(t.to(x.dtype) for t in (u, h, hg) if t is not None)


def fused_w1(x: torch.Tensor, row_src: torch.Tensor, tile_expert: torch.Tensor,
             w1: torch.Tensor, w1g: Optional[torch.Tensor] = None, *,
             act: str = "relu", save_preact: bool = False):
    """x (N, K_pad) unsorted rows; row_src (M_pad,) int32 with sentinels;
    tile_expert (M_pad//TM,) int32; w1, w1g (E, K_pad, G_pad) in x's dtype.
    Returns u (M_pad, G_pad) in x's dtype, or with ``save_preact`` the tuple
    (u, h) or (u, h, hg) with the pre-activations."""
    n_rows, k_pad = x.shape
    (m_pad,) = row_src.shape
    e, k_w, g_pad = w1.shape
    if (k_w != k_pad or m_pad % TM or k_pad % LANE or g_pad % LANE
            or tile_expert.shape != (m_pad // TM,)
            or (w1g is not None and w1g.shape != w1.shape)):
        raise ValueError(f"fused_w1: bad shapes x {tuple(x.shape)}, row_src "
                         f"{tuple(row_src.shape)}, w1 {tuple(w1.shape)}")
    if (x.dtype not in _DTYPE_CODE or w1.dtype != x.dtype
            or (w1g is not None and w1g.dtype != x.dtype)):
        raise ValueError(f"fused_w1: dtypes x {x.dtype}, w1 {w1.dtype}; need "
                         "matching float32 or bfloat16")
    if act not in ACTIVATIONS:
        raise ValueError(f"fused_w1: activation {act!r} is not one of "
                         f"{sorted(ACTIVATIONS)}")
    if _use_plain(x):
        return fused_w1_plain(x, row_src, tile_expert, w1, w1g, act=act,
                              save_preact=save_preact)
    _check_cuda("fused_w1", x, row_src, tile_expert, w1, w1g)
    if row_src.dtype != torch.int32 or tile_expert.dtype != torch.int32:
        raise ValueError("fused_w1: row_src and tile_expert must be int32")
    n_out = (2 + (w1g is not None)) if save_preact else 1
    outs = [torch.empty((m_pad, g_pad), dtype=x.dtype, device=x.device)
            for _ in range(n_out)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - n_out)
    bn, _, grid = row_gemm_schedule(m_pad, k_pad, g_pad, _sm_count(x.device),
                                    glu=w1g is not None, save=save_preact)
    fn = _fn("fused_w1", "repro_fused_w1",
             [_C] * 8 + [_I] * 9 + [_C])
    rc = fn(x.data_ptr(), row_src.data_ptr(), tile_expert.data_ptr(),
            w1.data_ptr(), None if w1g is None else w1g.data_ptr(), *ptrs,
            n_rows, m_pad, k_pad, g_pad, e, ACTIVATIONS[act],
            _DTYPE_CODE[x.dtype], bn, grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    _launch_status("fused_w1", rc)
    LAUNCHES["fused_w1"] += 1
    return tuple(outs) if save_preact else outs[0]


# ---------------------------------------------------------------------------
# K2: grouped GEMM with the gate multiply in the epilogue
# ---------------------------------------------------------------------------

def fused_w2_plain(u_pad: torch.Tensor, tile_expert: torch.Tensor,
                   w2: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fused_w2``: per-tile products in float32, times
    the float32 gate, rounded once."""
    m_pad = u_pad.shape[0]
    y = torch.bmm(_tiles(u_pad), w2[tile_expert.long()].float())
    return (y.reshape(m_pad, -1) * gate[:, None]).to(u_pad.dtype)


def fused_w2(u_pad: torch.Tensor, tile_expert: torch.Tensor, w2: torch.Tensor,
             gate: torch.Tensor) -> torch.Tensor:
    """u_pad (M_pad, G_pad) tile-aligned; tile_expert (M_pad//TM,) int32;
    w2 (E, G_pad, N_pad) in u's dtype; gate (M_pad,) float32. Returns
    (M_pad, N_pad) in u's dtype."""
    m_pad, g_pad = u_pad.shape
    e, g_w, n_pad = w2.shape
    if (g_w != g_pad or m_pad % TM or g_pad % LANE or n_pad % LANE
            or tile_expert.shape != (m_pad // TM,) or gate.shape != (m_pad,)):
        raise ValueError(f"fused_w2: bad shapes u {tuple(u_pad.shape)}, w2 "
                         f"{tuple(w2.shape)}, gate {tuple(gate.shape)}")
    if (u_pad.dtype not in _DTYPE_CODE or w2.dtype != u_pad.dtype
            or gate.dtype != torch.float32):
        raise ValueError(f"fused_w2: dtypes u {u_pad.dtype}, w2 {w2.dtype}, "
                         f"gate {gate.dtype}; need matching float32 or "
                         "bfloat16 and a float32 gate")
    if _use_plain(u_pad):
        return fused_w2_plain(u_pad, tile_expert, w2, gate)
    _check_cuda("fused_w2", u_pad, tile_expert, w2, gate)
    if tile_expert.dtype != torch.int32:
        raise ValueError("fused_w2: tile_expert must be int32")
    out = torch.empty((m_pad, n_pad), dtype=u_pad.dtype, device=u_pad.device)
    bn, _, grid = row_gemm_schedule(m_pad, g_pad, n_pad, _sm_count(u_pad.device))
    fn = _fn("fused_w2", "repro_fused_w2", [_C] * 5 + [_I] * 7 + [_C])
    rc = fn(u_pad.data_ptr(), tile_expert.data_ptr(), w2.data_ptr(),
            gate.data_ptr(), out.data_ptr(), m_pad, g_pad, n_pad, e,
            _DTYPE_CODE[u_pad.dtype], bn, grid,
            torch.cuda.current_stream(u_pad.device).cuda_stream)
    _launch_status("fused_w2", rc)
    LAUNCHES["fused_w2"] += 1
    return out


# ---------------------------------------------------------------------------
# K3 and K5's split (csrc/dw_gemm.cuh): an expert's tiles go in chunks of at
# most DW_CHUNK tiles, one block per (chunk, output block); experts of
# several chunks sum float32 partials from a scratch array in chunk order.
# ---------------------------------------------------------------------------

# 5 gives wt103-47m-moe's training step (273 tiles, 16 experts, 4 output
# blocks) about 270 blocks with work: two waves on the H100's 132 SMs.
# Smaller chunks balance better but pay each block's start and combine more
# often (scripts/dw_chunk_sweep.py times the choices).
DW_CHUNK = 5


def dw_split(n_tiles: int, n_experts: int, chunk: int) -> Tuple[int, int]:
    """(work items per output block, float32 partial slots) of the split, as
    csrc/dw_gemm.cuh's ``n_items`` and ``n_slots`` size the grid and the
    scratch. Item q < ceil(n_tiles / chunk) is the chunk that starts at tile
    q * chunk; item ceil(n_tiles / chunk) + e is expert e's first chunk when
    that starts off a multiple of ``chunk``, or its zeros when it has no
    tiles. Slot 2 * (t // chunk) + (t % chunk != 0) holds the partial of the
    chunk that starts at tile t."""
    n_chunks = -(-n_tiles // chunk)
    return n_chunks + n_experts, 2 * n_chunks


# Arrival counters of the kernels' in-launch combines (K3 and K5 here, K7's
# split merge), per (device, stream): zero between calls, since each call's
# last block of a combine resets its counter, and the calls on one stream
# run one after another, so they share one pool.
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(dev: torch.device, stream: int, need: int) -> torch.Tensor:
    """At least ``need`` zeroed int32 counters for a call on ``stream``."""
    key = (dev.index, stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < need:
        counters = _COUNTERS[key] = torch.zeros(need, dtype=torch.int32, device=dev)
    return counters


def _dw_workspace(dev: torch.device, stream: int, m_pad: int, k_pad: int, n_pad: int):
    """Scratch (torch.empty) and zeroed counters for one K3 or K5 call on
    ``stream``, and the slot count; the counters cover both dtypes' output
    blocks (64 x 64 in float32)."""
    _, slots = dw_split(m_pad // TM, 0, DW_CHUNK)
    scratch = torch.empty(slots * k_pad * n_pad, dtype=torch.float32, device=dev)
    return scratch, _counters(dev, stream, slots * (k_pad // 64) * (n_pad // 64)), slots


# ---------------------------------------------------------------------------
# K3: expert weight gradient with one operand gathered through row_src
# ---------------------------------------------------------------------------

def dw_streamed_plain(x: torch.Tensor, g: torch.Tensor, row_src: torch.Tensor,
                      tile_expert: torch.Tensor, n_experts: int, *,
                      stream_x: bool,
                      gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``dw_streamed``: both operands laid out tile by tile
    (slack rows zero in both), the gated rows rounded back to their dtype,
    per-tile A^T B in float32 summed per expert."""
    n_rows = (x if stream_x else g).shape[0]
    valid = ((row_src >= 0) & (row_src < n_rows))[:, None]
    if stream_x:
        a = gather_rows_plain(x, row_src)
        b = torch.where(valid, g, g.new_zeros(()))
    else:
        a = torch.where(valid, x, x.new_zeros(()))
        b = gather_rows_plain(g, row_src)
        if gate is not None:
            b = (b.float() * gate[:, None]).to(b.dtype)
    prod = torch.bmm(_tiles(a).transpose(1, 2), _tiles(b))
    out = torch.zeros((n_experts,) + prod.shape[1:], dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, tile_expert.long(), prod)


def dw_streamed(x: torch.Tensor, g: torch.Tensor, row_src: torch.Tensor,
                tile_expert: torch.Tensor, n_experts: int, *, stream_x: bool,
                gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dW (E, K_pad, N_pad) float32, every expert's block written (zeros for
    an expert with no rows).

    stream_x=True:  x (N, K_pad) unsorted, read through row_src; g (M_pad,
                    N_pad) tile-aligned (dW1, dW1g).
    stream_x=False: x (M_pad, K_pad) tile-aligned; g (N, N_pad) unsorted,
                    read through row_src and scaled per row by ``gate``
                    (M_pad,) float32 when given (dW2)."""
    (m_pad,) = row_src.shape
    k_pad, n_pad = x.shape[1], g.shape[1]
    aligned = g if stream_x else x
    if (m_pad % TM or k_pad % LANE or n_pad % LANE or aligned.shape[0] != m_pad
            or tile_expert.shape != (m_pad // TM,)
            or (gate is not None and (stream_x or gate.shape != (m_pad,)))):
        raise ValueError(f"dw_streamed: bad shapes x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, row_src {tuple(row_src.shape)}, "
                         f"stream_x {stream_x}, gate "
                         f"{None if gate is None else tuple(gate.shape)}")
    if (x.dtype not in _DTYPE_CODE or g.dtype != x.dtype
            or (gate is not None and gate.dtype != torch.float32)):
        raise ValueError(f"dw_streamed: dtypes x {x.dtype}, g {g.dtype}; need "
                         "matching float32 or bfloat16 and a float32 gate")
    if _use_plain(x):
        return dw_streamed_plain(x, g, row_src, tile_expert, n_experts,
                                 stream_x=stream_x, gate=gate)
    _check_cuda("dw_streamed", x, g, row_src, tile_expert, gate)
    if row_src.dtype != torch.int32 or tile_expert.dtype != torch.int32:
        raise ValueError("dw_streamed: row_src and tile_expert must be int32")
    out = torch.empty((n_experts, k_pad, n_pad), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scratch, counters, slots = _dw_workspace(x.device, stream, m_pad, k_pad, n_pad)
    fn = _fn("dw_streamed", "repro_dw_streamed", [_C] * 8 + [_I] * 9 + [_C])
    rc = fn(x.data_ptr(), g.data_ptr(), row_src.data_ptr(),
            tile_expert.data_ptr(), None if gate is None else gate.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
            (x if stream_x else g).shape[0], m_pad, k_pad, n_pad, n_experts,
            int(stream_x), _DTYPE_CODE[x.dtype], DW_CHUNK, slots, stream)
    _launch_status("dw_streamed", rc)
    LAUNCHES["dw_streamed"] += 1
    return out


# ---------------------------------------------------------------------------
# K5: expert weight gradient over tile-aligned operands
# ---------------------------------------------------------------------------

def cvmm_dw_plain(x_pad: torch.Tensor, tile_expert: torch.Tensor,
                  g_pad: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Plain version of ``cvmm_dw``: per-tile x^T g in float32 summed per
    expert; zeros for an expert with no tiles."""
    prod = torch.bmm(_tiles(x_pad).transpose(1, 2), _tiles(g_pad))
    out = torch.zeros((n_experts,) + prod.shape[1:], dtype=torch.float32,
                      device=x_pad.device)
    return out.index_add_(0, tile_expert.long(), prod)


def cvmm_dw(x_pad: torch.Tensor, tile_expert: torch.Tensor,
            g_pad: torch.Tensor, n_experts: int) -> torch.Tensor:
    """x_pad (M_pad, K_pad) and g_pad (M_pad, N_pad) tile-aligned, slack rows
    zero, in one dtype; tile_expert (M_pad//TM,) int32, non-decreasing.
    Returns dW (E, K_pad, N_pad) float32, every expert's block written
    (zeros for an expert with no rows)."""
    m_pad, k_pad = x_pad.shape
    n_pad = g_pad.shape[1]
    if (m_pad % TM or k_pad % LANE or n_pad % LANE or g_pad.shape[0] != m_pad
            or tile_expert.shape != (m_pad // TM,)):
        raise ValueError(f"cvmm_dw: bad shapes x {tuple(x_pad.shape)}, g "
                         f"{tuple(g_pad.shape)}, tile_expert "
                         f"{tuple(tile_expert.shape)}")
    if x_pad.dtype not in _DTYPE_CODE or g_pad.dtype != x_pad.dtype:
        raise ValueError(f"cvmm_dw: dtypes x {x_pad.dtype}, g {g_pad.dtype}; "
                         "need matching float32 or bfloat16")
    if _use_plain(x_pad):
        return cvmm_dw_plain(x_pad, tile_expert, g_pad, n_experts)
    _check_cuda("cvmm_dw", x_pad, tile_expert, g_pad)
    if tile_expert.dtype != torch.int32:
        raise ValueError("cvmm_dw: tile_expert must be int32")
    out = torch.empty((n_experts, k_pad, n_pad), dtype=torch.float32,
                      device=x_pad.device)
    stream = torch.cuda.current_stream(x_pad.device).cuda_stream
    scratch, counters, slots = _dw_workspace(x_pad.device, stream, m_pad, k_pad, n_pad)
    fn = _fn("cvmm_dw", "repro_cvmm_dw", [_C] * 6 + [_I] * 7 + [_C])
    rc = fn(x_pad.data_ptr(), tile_expert.data_ptr(), g_pad.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), counters.data_ptr(), m_pad,
            k_pad, n_pad, n_experts, _DTYPE_CODE[x_pad.dtype], DW_CHUNK, slots,
            stream)
    _launch_status("cvmm_dw", rc)
    LAUNCHES["cvmm_dw"] += 1
    return out
