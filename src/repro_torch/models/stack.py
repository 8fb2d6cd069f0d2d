"""Layer stack (the reference's ``models/stack.py``): pre-norm residual
blocks over a layer pattern.

The reference stacks each pattern entry's parameters along a leading
``repeats`` axis and runs ``lax.scan`` over it. The port keeps the same
segment structure but holds one parameter dict per layer,
``params["segments"][si][f"e{ei}"][r]``, and runs a Python loop over the
layers. Caches and XL memories mirror that structure. Only attention
mixers with an FFN are ported; SSM mixers, shared blocks and
cross-attention raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..configs.base import BlockSpecEntry, ModelConfig
from .attention import (apply_attention, init_attention,
                        init_cache as init_attn_cache,
                        init_paged_cache as init_attn_paged_cache)
from .ffn import apply_ffn, init_ffn
from .layers import apply_norm, dropout, init_norm


@dataclass(frozen=True)
class Segment:
    entries: Tuple[BlockSpecEntry, ...]
    repeats: int


def plan_segments(cfg: ModelConfig, n_layers: Optional[int] = None) -> List[Segment]:
    n = n_layers if n_layers is not None else cfg.n_layers
    pattern = cfg.pattern or (BlockSpecEntry(mixer="attn", ffn="ffn"),)
    for entry in pattern:
        if entry.mixer != "attn" or entry.ffn not in ("ffn", "none"):
            raise NotImplementedError(
                f"block {entry}: only attention mixers are ported yet")
    p = len(pattern)
    segs = []
    if n // p:
        segs.append(Segment(tuple(pattern), n // p))
    if n % p:
        segs.append(Segment(tuple(pattern[: n % p]), 1))
    return segs


def init_block(gen: torch.Generator, cfg: ModelConfig, entry: BlockSpecEntry,
               dtype, ep_degree: int = 0, device="cuda") -> Dict:
    p = {"norm1": init_norm(cfg, cfg.d_model, dtype, device),
         "attn": init_attention(gen, cfg, dtype, device)}
    if entry.ffn == "ffn":
        p["norm2"] = init_norm(cfg, cfg.d_model, dtype, device)
        p["ffn"] = init_ffn(gen, cfg.d_model, cfg.ffn, cfg.n_layers, dtype,
                            ep_degree, device)
    return p


def apply_block(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                entry: BlockSpecEntry, *, positions: Optional[torch.Tensor],
                cache: Optional[Dict], cache_index,
                block_table: Optional[torch.Tensor] = None,
                seq_lens=None, memory: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None, train: bool = False
                ) -> Tuple[torch.Tensor, Dict, Optional[Dict],
                           Optional[torch.Tensor]]:
    """Pre-norm residual block. Returns (x, aux, new_cache, new_memory).
    With XL attention and a memory, the new memory is the last M rows of
    [memory, normed input], detached. Dropout draws from ``gen``."""
    aux = {}
    new_cache = new_memory = None
    h = apply_norm(params["norm1"], x, cfg)
    if cfg.pos_encoding == "xl_rel" and memory is not None:
        new_memory = torch.cat([memory.to(x.dtype), h],
                               dim=1)[:, -memory.shape[1]:].detach()
    y, c = apply_attention(params["attn"], h, cfg, kind=entry.attn_kind,
                           positions=positions,
                           cache=cache.get("self") if cache else None,
                           cache_index=cache_index, block_table=block_table,
                           seq_lens=seq_lens, memory=memory)
    if c is not None:
        new_cache = {"self": c}
    x = x + dropout(gen, y, cfg.dropout, train)
    if entry.ffn == "ffn":
        h = apply_norm(params["norm2"], x, cfg)
        y, aux = apply_ffn(params["ffn"], h, cfg.ffn, gen=gen, train=train)
        x = x + dropout(gen, y, cfg.dropout, train)
    return x, aux, new_cache, new_memory


def init_stack(gen: torch.Generator, cfg: ModelConfig, dtype, *,
               ep_degree: int = 0, device="cuda") -> Dict:
    return {"segments": [
        {f"e{ei}": [init_block(gen, cfg, entry, dtype, ep_degree, device)
                    for _ in range(seg.repeats)]
         for ei, entry in enumerate(seg.entries)}
        for seg in plan_segments(cfg)]}


def _stack_cache(cfg: ModelConfig, make) -> Dict:
    cache = {"segments": []}
    for seg in plan_segments(cfg):
        seg_cache = {}
        for ei in range(len(seg.entries)):
            seg_cache[f"e{ei}"] = [{"self": make()} for _ in range(seg.repeats)]
        cache["segments"].append(seg_cache)
    return cache


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device="cuda") -> Dict:
    return _stack_cache(cfg, lambda: init_attn_cache(cfg, batch, max_len,
                                                     dtype, device))


def init_paged_stack_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                           dtype, device="cuda") -> Dict:
    """Paged KV pools mirroring the stack structure (page 0 reserved); the
    per-request mapping lives in the block table passed to ``apply_stack``."""
    return _stack_cache(cfg, lambda: init_attn_paged_cache(
        cfg, n_pages, page_size, dtype, device))


def apply_stack(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None, cache_index=None,
                block_table: Optional[torch.Tensor] = None,
                seq_lens=None, mems: Optional[Dict] = None,
                gen: Optional[torch.Generator] = None, train: bool = False
                ) -> Tuple[torch.Tensor, Dict, Optional[Dict], Optional[Dict]]:
    """Run every layer in order. Returns (x, aux, new_cache, new_mems)."""
    aux_tot: Dict[str, torch.Tensor] = {}
    new_cache = {"segments": []} if cache is not None else None
    new_mems = {"segments": []} if mems is not None else None
    for si, seg in enumerate(plan_segments(cfg)):
        seg_params = params["segments"][si]
        seg_cache = cache["segments"][si] if cache is not None else None
        seg_mems = mems["segments"][si] if mems is not None else None
        new_seg = {f"e{ei}": [] for ei in range(len(seg.entries))}
        new_seg_mems = {k: [] for k in (seg_mems or {})}
        for r in range(seg.repeats):
            for ei, entry in enumerate(seg.entries):
                c = seg_cache[f"e{ei}"][r] if seg_cache is not None else None
                m = (seg_mems[f"e{ei}"][r]
                     if seg_mems is not None and f"e{ei}" in seg_mems else None)
                x, aux, nc, nm = apply_block(
                    seg_params[f"e{ei}"][r], x, cfg, entry,
                    positions=positions, cache=c, cache_index=cache_index,
                    block_table=block_table, seq_lens=seq_lens, memory=m,
                    gen=gen, train=train)
                for key, val in aux.items():
                    aux_tot[key] = aux_tot.get(key, 0.0) + val
                new_seg[f"e{ei}"].append(nc)
                if nm is not None:
                    new_seg_mems[f"e{ei}"].append(nm)
        if new_cache is not None:
            new_cache["segments"].append(new_seg)
        if new_mems is not None:
            new_mems["segments"].append(new_seg_mems)
    return x, aux_tot, new_cache, new_mems


def init_mems(cfg: ModelConfig, batch: int, dtype,
              device="cuda") -> Dict:
    """XL segment memory (zeros), mirroring the stack structure: one
    (batch, xl_memory, d_model) tensor per attention layer."""
    return {"segments": [
        {f"e{ei}": [torch.zeros((batch, cfg.xl_memory, cfg.d_model),
                                dtype=dtype, device=device)
                    for _ in range(seg.repeats)]
         for ei, entry in enumerate(seg.entries) if entry.mixer == "attn"}
        for seg in plan_segments(cfg)]}
