"""Forward-only grouped-query attention on Hopper (K7), the counterpart of
the reference's ``kernels/flash_attention.py``.

  ``flash_attention(q, k, v, causal=, scale=, q_offset=, kv_len=)``
      out = softmax(scale · q kᵀ, masked) v with an online softmax in
      float32; replaces ``flash_attention_pallas``; CUDA source
      ``csrc/flash_attention.cu``.

Layout (the reference's): q (B, Sq, H, D), k and v (B, Sk, KV, D) with
H % KV == 0, query head h reading KV head h // (H // KV); the output is
(B, Sq, H, D) in q's dtype. Beyond the reference kernel's contract, which
masks only keys past Sk and counts causal positions from 0, the query rows
sit at absolute positions ``q_offset + i`` (a prefill chunk's start) and
batch row b sees only keys below ``kv_len[b]`` (a (B,) integer tensor on
q's device, read there, so the host never syncs). Those are the masks of
the chunked core ``flash_attention_plain`` that K7 replaces, which
``models.attention`` runs for the calls K7 does not take.

A row that sees no key at all is zero, the pure-JAX path's convention (it
masks with -inf). The Pallas kernel masks with a finite -1e30 instead and
would average V over such a row. No caller makes one: with
``kv_len >= 1`` key 0 is visible to every causal row.

In bf16 the kernel packs the ``H // KV`` query heads of a KV head into
128-row tiles of (position, head) rows and may split each tile's keys over
several blocks, merged in the same launch; ``flash_schedule`` sizes the
grid (csrc/flash_attention.cu describes the design).

As for the kernels of ``kernels/cvmm.py``, the plain version
``flash_attention_plain`` runs for CPU tensors and only for them; a CUDA
tensor launches the kernel or raises, also when grad mode is on and an
input requires grad (K7 has no backward; the reference's kernel is forward
only too). Launches count in ``cvmm.LAUNCHES["flash_attention"]``.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from .cvmm import (LAUNCHES, _C, _DTYPE_CODE, _I, _check_cuda, _counters, _fn,
                   _launch_status, _sm_count, _use_plain)

HEAD_DIMS = (16, 64, 112, 128)   # csrc/flash_attention.cu's instantiations

# ---------------------------------------------------------------------------
# The bf16 kernel's schedule (csrc/flash_attention.cu, flash_fwd_bf16). An
# item is (batch row, KV head, ROW_TILE-row tile of the packed rows), packed
# row r being position r // grp of query head kv * grp + r % grp (grp = H //
# KV). Its host-known keys, [0, min(Sk, q_offset + its last position + 1))
# (all Sk without the causal mask), are FLASH_BK[D]-key tiles cut into at
# most ``splits`` contiguous balanced runs of at least MIN_TILES tiles; the
# grid is items x splits blocks, block i taking split i % splits of item
# i // splits, one block an SM (the kernel's shared memory and registers).
# ---------------------------------------------------------------------------
ROW_TILE = 128
MIN_TILES = 4
FLASH_BK = {16: 128, 64: 128, 112: 64, 128: 64}     # keys a tile, by head size
SCRATCH_THREADS = 256                       # the kernel's consumer threads


def flash_item_tiles(rt: int, sq: int, sk: int, grp: int, causal: bool, q_offset: int,
                     bk: int) -> int:
    """Key tiles of row tile ``rt``'s items known on the host: up to the
    causal limit of its last packed row (``kv_len`` cuts them further on the
    device)."""
    last = min(sq - 1, (rt * ROW_TILE + ROW_TILE - 1) // grp)
    keys = min(sk, q_offset + last + 1) if causal else sk
    return -(-max(keys, 0) // bk)


def flash_split_ranges(n_tiles: int, splits: int) -> List[Tuple[int, int]]:
    """The [lo, hi) key-tile runs of an item of ``n_tiles`` tiles under a
    schedule of ``splits``: min(splits, n_tiles // MIN_TILES) of them (at
    least one), contiguous, in order, sizes differing by at most one."""
    n = min(splits, max(1, n_tiles // MIN_TILES))
    return [(k * n_tiles // n, (k + 1) * n_tiles // n) for k in range(n)]


def flash_packed_rows(rt: int, sq: int, grp: int) -> Tuple[List[int], List[int]]:
    """(position, head in the group) of each packed row of row tile ``rt``
    that lies inside the call (the tile's rows past Sq * grp are padding)."""
    rows = range(rt * ROW_TILE, min((rt + 1) * ROW_TILE, sq * grp))
    return [r // grp for r in rows], [r % grp for r in rows]


def flash_schedule(b: int, sq: int, h: int, kvh: int, sk: int, q_offset: int, causal: bool,
                   n_sms: int, bk: int = FLASH_BK[64]) -> Tuple[int, int, int, int]:
    """(row tile, items, splits, grid) of one bf16 K7 call on a card of
    ``n_sms`` SMs: the most splits with items x splits at most one block an
    SM, and no more than the longest item's tiles // MIN_TILES (at least
    one). Reads no device value: ``kv_len`` is left to the kernel."""
    grp = h // kvh
    n_rt = -(-sq * grp // ROW_TILE)
    items = b * kvh * n_rt
    longest = flash_item_tiles(n_rt - 1, sq, sk, grp, causal, q_offset, bk)  # the last tile's
    splits = max(1, min(longest // MIN_TILES, n_sms // items))
    return ROW_TILE, items, splits, items * splits


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool, scale: float, q_offset=0,
                          kv_len: Optional[torch.Tensor] = None, window: int = 0,
                          kv_chunk: int = 2048) -> torch.Tensor:
    """Plain version of ``flash_attention``, and the chunked core that
    training and windowed layers run: a loop over ``kv_chunk``-key chunks
    carrying the online-softmax state in float32, so (Sq, Sk) is never
    materialized; -inf masks (a row with no visible key gives zeros), rows
    divided by max(l, 1e-20), rounded to q's dtype once. ``q_offset`` is an
    int or a 0-d tensor; ``window`` > 0 also masks keys at or before
    ``q_offset + i - window`` (K7 has no window)."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dev = q.device
    qg = q.reshape(b, sq, kvh, h // kvh, dh).float()
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, kvh, h // kvh, sq), float("-inf"), device=dev)
    l = torch.zeros((b, kvh, h // kvh, sq), device=dev)
    acc = torch.zeros((b, kvh, h // kvh, sq, dh), device=dev)
    for c0 in range(0, sk, kv_chunk):
        kb = k[:, c0:c0 + kv_chunk].float()
        vb = v[:, c0:c0 + kv_chunk].float()
        k_pos = c0 + torch.arange(kb.shape[1], device=dev)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kb) * scale
        mask = torch.ones((sq, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        full = mask[None, None, None]                       # (1,1,1,Sq,C)
        if kv_len is not None:
            full = full & (k_pos[None, :] < kv_len.to(dev)[:, None])[:, None, None, None, :]
        s = s.masked_fill(~full, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isneginf(s), 0.0, p)
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, scale: float, q_offset: int = 0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, D), k and v (B, Sk, KV, D) in one dtype (float32 or
    bfloat16), H % KV == 0; ``q_offset`` a Python int; ``kv_len`` (B,)
    int64 or None. Returns (B, Sq, H, D) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} must be (B, S, heads, D)")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != d or v.shape != k.shape or h % kvh
            or sq == 0 or sk == 0):
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes q {q.dtype}, k {k.dtype}, "
                         f"v {v.dtype}; need matching float32 or bfloat16")
    if kv_len is not None and (kv_len.shape != (b,) or kv_len.is_floating_point()):
        raise ValueError("flash_attention: kv_len must be a (B,) integer tensor")
    q_offset = int(q_offset)
    if _use_plain(q):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, kv_len=kv_len)
    _check_cuda("flash_attention", q, k, v, kv_len,
                remedy="K7 is forward only: differentiate through the chunked "
                       "flash_attention_plain, or call this wrapper under "
                       "torch.no_grad().")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head size {d} is not one of {HEAD_DIMS}")
    if kv_len is not None and kv_len.dtype != torch.int64:
        raise ValueError("flash_attention: kv_len must be int64")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bk, splits, scratch, counters = 0, 1, None, None
    if q.dtype == torch.bfloat16:
        bk = FLASH_BK[d]
        _, items, splits, grid = flash_schedule(b, sq, h, kvh, sk, q_offset, causal,
                                                _sm_count(q.device), bk)
        if splits > 1:
            scratch = torch.empty(grid * (d // 2 + 4) * SCRATCH_THREADS,
                                  dtype=torch.float32, device=q.device)
            counters = _counters(q.device, stream, items)
    fn = _fn("flash_attention", "repro_flash_attention",
             [_C, _C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
              _I, _I, _I, _C])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if counters is None else counters.data_ptr(),
            b, sq, sk, h, kvh, d, float(scale), int(causal), q_offset,
            _DTYPE_CODE[q.dtype], bk, splits, stream)
    _launch_status("flash_attention", rc)
    LAUNCHES["flash_attention"] += 1
    return out
