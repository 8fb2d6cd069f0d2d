"""CVMM kernels on Hopper: the grouped GEMM (K4) and the row gather (K6).

Layout contract (shared with kernels/ops.py, as in the reference's
``kernels/cvmm.py``): rows are sorted by expert and each expert's range is
padded to a multiple of the row tile ``TM`` = 128, so every 128-row tile
belongs to exactly one expert.

  ``cvmm(x_pad, tile_expert, w)``        out[t] = x_pad[t] @ w[tile_expert[t]]
      replaces ``cvmm_pallas``; CUDA source ``csrc/cvmm.cu``.
  ``gather_rows(x, row_src, weight)``    out[s] = x[row_src[s]] (* weight[s])
      replaces ``cvmm_gather_rows_pallas``; CUDA source ``csrc/gather_rows.cu``.

Each wrapper takes its plain PyTorch version (``cvmm_plain``,
``gather_rows_plain``) only for tensors on the CPU. For a CUDA tensor it
launches the kernel on the current stream, or raises. ``LAUNCHES`` counts
kernel launches per wrapper; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

TM = 128
LANE = 128

LAUNCHES = {"cvmm": 0, "gather_rows": 0}

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


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
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
    if x_pad.device.type == "cpu":
        return cvmm_plain(x_pad, tile_expert, w)
    if x_pad.device.type != "cuda":
        raise ValueError(f"cvmm: unsupported device {x_pad.device}")
    if tile_expert.dtype != torch.int32:
        raise ValueError("cvmm: tile_expert must be int32")
    _check_cuda("cvmm", x_pad, tile_expert, w)
    out = torch.empty((m_pad, n_pad), dtype=x_pad.dtype, device=x_pad.device)
    fn = _fn("cvmm", "repro_cvmm", [_C, _C, _C, _C, _I, _I, _I, _I, _I, _C])
    rc = fn(x_pad.data_ptr(), tile_expert.data_ptr(), w.data_ptr(),
            out.data_ptr(), m_pad, k_pad, n_pad, e,
            _DTYPE_CODE[x_pad.dtype],
            torch.cuda.current_stream(x_pad.device).cuda_stream)
    _launch_status("cvmm", rc)
    LAUNCHES["cvmm"] += 1
    return out


# ---------------------------------------------------------------------------
# K6: row gather with a sentinel, optionally weighted
# ---------------------------------------------------------------------------

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
    if x.device.type == "cpu":
        return gather_rows_plain(x, row_src, weight)
    if x.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {x.device}")
    if row_src.dtype != torch.int32:
        raise ValueError("gather_rows: row_src must be int32")
    _check_cuda("gather_rows", x, row_src,
                *(() if weight is None else (weight,)))
    out = torch.empty((m_pad, k_pad), dtype=x.dtype, device=x.device)
    fn = _fn("gather_rows", "repro_gather_rows",
             [_C, _C, _C, _C, _I, _I, _I, _I, _C])
    rc = fn(x.data_ptr(), row_src.data_ptr(),
            None if weight is None else weight.data_ptr(), out.data_ptr(),
            n_rows, m_pad, k_pad, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _launch_status("gather_rows", rc)
    LAUNCHES["gather_rows"] += 1
    return out
