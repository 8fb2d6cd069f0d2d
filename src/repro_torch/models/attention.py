"""Attention (the reference's ``models/attention.py``): GQA with a chunked
online-softmax core, single-token decode attention, the paged KV cache that
serving uses, and Transformer-XL relative-position attention over a
detached segment memory (the paper's training architecture).

These are plain tensor ops in the reference too, so they stay plain torch.
Cross-attention is not ported yet.

KV caches are updated in place (the reference returns new arrays; its
engine donates the old ones, so nothing observes the difference) to keep
one copy of the pool in device memory.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import AttentionConfig, ModelConfig
from .layers import apply_rope, rms_norm_simple, sinusoid_positions


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32, device="cuda") -> Dict:
    a = cfg.attention
    d = cfg.d_model

    def rn(shape, std):
        return std * torch.randn(shape, generator=gen, dtype=dtype,
                                 device=device)

    std = d ** -0.5
    p = {"wq": rn((d, a.q_dim), std), "wk": rn((d, a.kv_dim), std),
         "wv": rn((d, a.kv_dim), std), "wo": rn((a.q_dim, d), a.q_dim ** -0.5)}
    if a.qk_norm:
        p["q_scale"] = torch.ones((a.head_dim,), dtype=dtype, device=device)
        p["k_scale"] = torch.ones((a.head_dim,), dtype=dtype, device=device)
    if a.kind == "xl_rel":
        p["w_r"] = rn((d, a.q_dim), std)
        p["u_bias"] = torch.zeros((a.n_heads, a.head_dim), dtype=dtype,
                                  device=device)
        p["v_bias"] = torch.zeros((a.n_heads, a.head_dim), dtype=dtype,
                                  device=device)
    return p


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def _gqa_expand(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,S,H,D) -> (B,S,KV,Grp,D) for grouped-query attention."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    return q.reshape(b, s, kvh, h // kvh, dh)


# ---------------------------------------------------------------------------
# Chunked online-softmax core
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, scale: float,
                    q_offset=0, kv_chunk: int = 2048,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,KV,D) -> (B,Sq,H,D); a loop over KV chunks
    carrying the online-softmax state, so (Sq, Sk) is never materialized.

    q_offset: absolute position of q[0] relative to k[0] (int or 0-d tensor).
    kv_len: optional (B,) valid KV lengths."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    dev = q.device
    qg = _gqa_expand(q, k).float()
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, kvh, grp, sq), float("-inf"), device=dev)
    l = torch.zeros((b, kvh, grp, sq), device=dev)
    acc = torch.zeros((b, kvh, grp, sq, dh), device=dev)
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
            full = full & (k_pos[None, :] < kv_len[:, None])[:, None, None, None, :]
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
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float, q_pos, window: int = 0,
                     kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token attention: q (B,1,H,D) against k/v (B,Smax,KV,D).
    q_pos is a scalar or (B,) per-lane positions."""
    b, _, h, dh = q.shape
    smax, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, dh).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    pos = torch.arange(smax, device=q.device)
    mask = torch.ones((1, smax), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask = pos[None, :] < kv_len[:, None]               # (B, Smax)
    if window:
        qp = torch.as_tensor(q_pos, device=q.device).reshape(-1)
        mask = mask & (pos[None, :] > qp[:, None] - window)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Paged (block) KV cache
# ---------------------------------------------------------------------------

def paged_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache: Dict, block_table: torch.Tensor, cache_index,
                 seq_lens, *, scale: float, window: int = 0,
                 kv_chunk: int = 2048) -> Tuple[torch.Tensor, Dict]:
    """Attention against a paged KV pool (contract in serving/__init__.py).

    cache: {"k": (P, ps, KV, D), "v": ...}; page 0 is the reserved scratch
    page. block_table (B, n_blocks) maps logical to physical pages.

    decode (Sq == 1): ``cache_index`` is the (B,) write position of each
    lane; attention masks each lane at ``kv_len = pos + 1``.

    prefill chunk (Sq > 1, B == 1): ``cache_index`` is the chunk's absolute
    start and ``seq_lens`` its valid length. The reference drops the padded
    tail's writes on an out-of-bounds page; here they go to the scratch page
    0, which every reader masks out, so no host sync is needed to drop them.
    """
    b, sq = q.shape[0], q.shape[1]
    ps = cache["k"].shape[1]
    ck, cv = cache["k"], cache["v"]
    cdt = ck.dtype
    if sq == 1:
        pos = torch.as_tensor(cache_index, device=q.device).long()  # (B,)
        page = torch.gather(block_table.long(), 1, (pos // ps)[:, None])[:, 0]
        off = pos % ps
        ck[page, off] = k[:, 0].to(cdt)
        cv[page, off] = v[:, 0].to(cdt)
        gk = ck[block_table.long()].reshape(b, -1, *ck.shape[2:])
        gv = cv[block_table.long()].reshape(b, -1, *cv.shape[2:])
        out = decode_attention(q, gk.to(q.dtype), gv.to(q.dtype), scale=scale,
                               q_pos=pos, window=window, kv_len=pos + 1)
    else:
        if b != 1:
            raise NotImplementedError("paged prefill runs one request per "
                                      "chunk (B == 1)")
        start = int(cache_index)
        length = int(seq_lens)
        table = block_table[0].long()
        pos = start + torch.arange(sq, device=q.device)
        valid = torch.arange(sq, device=q.device) < length
        lpage = torch.clamp(pos // ps, max=table.shape[0] - 1)
        page = torch.where(valid, table[lpage], 0)
        off = pos % ps
        ck[page, off] = k[0].to(cdt)
        cv[page, off] = v[0].to(cdt)
        gk = ck[table].reshape(1, -1, *ck.shape[2:])
        gv = cv[table].reshape(1, -1, *cv.shape[2:])
        out = flash_attention(q, gk.to(q.dtype), gv.to(q.dtype), causal=True,
                              window=window, scale=scale, q_offset=start,
                              kv_chunk=kv_chunk,
                              kv_len=torch.tensor([start + length],
                                                  device=q.device))
    return out, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Transformer-XL relative-position attention (the paper's architecture)
# ---------------------------------------------------------------------------

def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B,H,Sq,Sk) BD-term shift (Dai et al. 2019)."""
    b, h, sq, sk = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(b, h, sk + 1, sq)[:, :, 1:, :]
    return x.reshape(b, h, sq, sk)


def xl_attention(params: Dict, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, cfg: AttentionConfig,
                 d_model: int) -> torch.Tensor:
    """q (B,Sq,H,D); k/v (B,Sk,H,D) where Sk = mem + Sq. Full scores (the
    contexts are small), softmax in float32."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    scale = cfg.softmax_scale or (dh ** -0.5)
    r = sinusoid_positions(sk, d_model, q.dtype, q.device).flip(0)  # sk-1..0
    r = (r @ params["w_r"].to(q.dtype)).reshape(sk, h, dh)
    ac = torch.einsum("bqhd,bkhd->bhqk", q + params["u_bias"].to(q.dtype), k)
    bd = torch.einsum("bqhd,khd->bhqk", q + params["v_bias"].to(q.dtype), r)
    s = (ac + _rel_shift(bd)).float() * scale
    q_pos = (sk - sq) + torch.arange(sq, device=q.device)
    mask = q_pos[:, None] >= torch.arange(sk, device=q.device)[None, :]
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


# ---------------------------------------------------------------------------
# Block-level apply
# ---------------------------------------------------------------------------

def apply_attention(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                    kind: str = "", positions: Optional[torch.Tensor] = None,
                    cache: Optional[Dict] = None, cache_index=None,
                    block_table: Optional[torch.Tensor] = None,
                    seq_lens=None, memory: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One attention sublayer (projections + core + output).

    cache: {"k": (B,Smax,KV,D), "v": ...} with cache_index the write start,
    or, with ``block_table``, the paged pool (see ``paged_attend``).
    memory: XL segment memory (B, M, d_model); it gets no gradient.
    Returns (output, updated cache or None)."""
    a = cfg.attention
    kind = kind or a.kind
    b, s, d = x.shape
    scale = a.softmax_scale if a.softmax_scale else a.head_dim ** -0.5
    q = _split_heads(x @ params["wq"].to(x.dtype), a.n_heads, a.head_dim)
    src = x if memory is None else torch.cat(
        [memory.detach().to(x.dtype), x], dim=1)
    k = _split_heads(src @ params["wk"].to(x.dtype), a.n_kv_heads, a.head_dim)
    v = _split_heads(src @ params["wv"].to(x.dtype), a.n_kv_heads, a.head_dim)
    if a.qk_norm:
        q = rms_norm_simple(q, params["q_scale"])
        k = rms_norm_simple(k, params["k_scale"])
    if kind == "xl_rel":
        out = xl_attention(params, q, k, v, a, d)
        return out.reshape(b, s, a.q_dim) @ params["wo"].to(x.dtype), None
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if cfg.pos_encoding == "rope":
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    win = a.window if kind == "local" else 0

    new_cache = None
    if cache is not None and block_table is not None:
        out, new_cache = paged_attend(q, k, v, cache, block_table, cache_index,
                                      seq_lens, scale=scale, window=win,
                                      kv_chunk=a.kv_chunk)
    elif cache is not None:
        idx = int(cache_index)
        ck, cv = cache["k"], cache["v"]
        ck[:, idx:idx + s] = k.to(ck.dtype)
        cv[:, idx:idx + s] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        kv_len = torch.full((b,), idx + s, device=x.device)
        if s == 1:
            out = decode_attention(q, ck.to(q.dtype), cv.to(q.dtype),
                                   scale=scale, q_pos=idx, window=win,
                                   kv_len=kv_len)
        else:
            out = flash_attention(q, ck.to(q.dtype), cv.to(q.dtype),
                                  causal=True, window=win, scale=scale,
                                  q_offset=idx, kv_chunk=a.kv_chunk,
                                  kv_len=kv_len)
    else:
        out = flash_attention(q, k, v, causal=a.causal and kind != "noncausal",
                              window=win, scale=scale, kv_chunk=a.kv_chunk)
    y = out.reshape(b, s, a.q_dim) @ params["wo"].to(x.dtype)
    return y, new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict:
    a = cfg.attention
    shape = (batch, max_len, a.n_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype=torch.bfloat16, device="cuda") -> Dict:
    """One layer's paged KV pool: P pages of ps slots, shared by all
    requests through block tables. Page 0 is the reserved scratch page."""
    a = cfg.attention
    shape = (n_pages, page_size, a.n_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
