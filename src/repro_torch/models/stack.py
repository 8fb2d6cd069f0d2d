"""Layer stack (the reference's ``models/stack.py``): pre-norm residual
blocks over a layer pattern.

The reference stacks each pattern entry's parameters along a leading
``repeats`` axis and runs ``lax.scan`` over it. The port keeps the same
segment structure but holds one parameter dict per layer,
``params["segments"][si][f"e{ei}"][r]``, and runs a Python loop over the
layers. Caches and XL memories mirror that structure.

Mixers: attention ("attn"), Mamba2's SSD ("ssm", ``models/mamba2.py``) and
zamba2's shared block ("shared_attn" and "shared_ffn" entries), whose one
set of weights, ``params["shared"]``, every such slot applies (each slot
keeps its own KV cache). With ``cross`` every block also holds a
cross-attention over the encoder's output (whisper's decoder).

``remat`` recomputes each block in the backward instead of keeping its
activations, as the reference's ``jax.checkpoint`` around each scanned
block does: "full" keeps only the block's inputs, "dots" also the outputs
of the matrix products without batch dimensions (``aten.mm``/``addmm``,
JAX's ``dots_with_no_batch_dims_saveable``). The recomputation replays
the block's random draws from the explicit generator (``_remat_block``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from ..configs.base import BlockSpecEntry, ModelConfig
from .attention import (_split_heads, apply_attention, init_attention,
                        init_cache as init_attn_cache,
                        init_paged_cache as init_attn_paged_cache)
from .ffn import apply_ffn, init_ffn
from .layers import apply_norm, dropout, init_norm
from .mamba2 import apply_ssm, init_ssm, init_ssm_cache


@dataclass(frozen=True)
class Segment:
    entries: Tuple[BlockSpecEntry, ...]
    repeats: int


def plan_segments(cfg: ModelConfig, n_layers: Optional[int] = None) -> List[Segment]:
    n = n_layers if n_layers is not None else cfg.n_layers
    pattern = cfg.pattern or (BlockSpecEntry(mixer="attn", ffn="ffn"),)
    p = len(pattern)
    segs = []
    if n // p:
        segs.append(Segment(tuple(pattern), n // p))
    if n % p:
        segs.append(Segment(tuple(pattern[: n % p]), 1))
    return segs


def _needs_shared(cfg: ModelConfig) -> bool:
    return any(e.mixer == "shared_attn" or e.ffn == "shared_ffn"
               for e in (cfg.pattern or ()))


def init_block(gen: torch.Generator, cfg: ModelConfig, entry: BlockSpecEntry,
               dtype, ep_degree: int = 0, device="cuda", cross: bool = False) -> Dict:
    """One layer's own parameters: its mixer's (none for a shared slot),
    the cross-attention with ``cross``, and its FFN unless it has none or
    the shared one."""
    p = {}
    if entry.mixer == "attn":
        p["norm1"] = init_norm(cfg, cfg.d_model, dtype, device)
        p["attn"] = init_attention(gen, cfg, dtype, device)
    elif entry.mixer == "ssm":
        p["norm1"] = init_norm(cfg, cfg.d_model, dtype, device)
        p["ssm"] = init_ssm(gen, cfg, dtype, device)
    if cross:
        p["norm_x"] = init_norm(cfg, cfg.d_model, dtype, device)
        p["cross"] = init_attention(gen, cfg, dtype, device)
    if entry.ffn == "ffn":
        p["norm2"] = init_norm(cfg, cfg.d_model, dtype, device)
        p["ffn"] = init_ffn(gen, cfg.d_model, cfg.ffn, cfg.n_layers, dtype,
                            ep_degree, device)
    return p


def init_shared_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                      device="cuda") -> Dict:
    """zamba2's shared block: attention + MLP applied at many depths."""
    return {"norm1": init_norm(cfg, cfg.d_model, dtype, device),
            "attn": init_attention(gen, cfg, dtype, device),
            "norm2": init_norm(cfg, cfg.d_model, dtype, device),
            "ffn": init_ffn(gen, cfg.d_model, cfg.ffn, cfg.n_layers, dtype, 0, device)}


def apply_block(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                entry: BlockSpecEntry, *, positions: Optional[torch.Tensor],
                cache: Optional[Dict], cache_index,
                block_table: Optional[torch.Tensor] = None,
                seq_lens=None, memory: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None, train: bool = False,
                shared: Optional[Dict] = None,
                enc_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict, Optional[Dict],
                           Optional[torch.Tensor]]:
    """Pre-norm residual block. Returns (x, aux, new_cache, new_memory).
    With XL attention and a memory, the new memory is the last M rows of
    [memory, normed input], detached. A shared slot runs ``shared``'s
    weights. The cross-attention reads ``cache["cross"]`` (the encoder's
    keys and values, made at prefill) or else projects ``enc_out``.
    Dropout draws from ``gen``."""
    aux = {}
    new_cache = {}
    new_memory = None
    mixer_params, mixer = params, entry.mixer
    if mixer == "shared_attn":
        mixer_params, mixer = shared, "attn"
    if mixer == "attn":
        h = apply_norm(mixer_params["norm1"], x, cfg)
        if cfg.pos_encoding == "xl_rel" and memory is not None:
            new_memory = torch.cat([memory.to(x.dtype), h],
                                   dim=1)[:, -memory.shape[1]:].detach()
        y, c = apply_attention(mixer_params["attn"], h, cfg, kind=entry.attn_kind,
                               positions=positions,
                               cache=cache.get("self") if cache else None,
                               cache_index=cache_index, block_table=block_table,
                               seq_lens=seq_lens, memory=memory)
        if c is not None:
            new_cache["self"] = c
        x = x + dropout(gen, y, cfg.dropout, train)
    elif mixer == "ssm":
        h = apply_norm(params["norm1"], x, cfg)
        y, c = apply_ssm(params["ssm"], h, cfg,
                         cache=cache.get("ssm") if cache else None)
        if c is not None:
            new_cache["ssm"] = c
        x = x + dropout(gen, y, cfg.dropout, train)

    cross_cache = cache.get("cross") if cache else None
    if "cross" in params and (enc_out is not None or cross_cache is not None):
        h = apply_norm(params["norm_x"], x, cfg)
        if cross_cache is not None:
            kv = (cross_cache["k"].to(h.dtype), cross_cache["v"].to(h.dtype))
            new_cache["cross"] = cross_cache      # fixed after prefill
        else:
            kv = _cross_kv(params["cross"], enc_out.to(h.dtype), cfg)
        y, _ = apply_attention(params["cross"], h, cfg, positions=positions,
                               cross_kv=kv)
        x = x + dropout(gen, y, cfg.dropout, train)

    if entry.ffn != "none":
        fp = shared if entry.ffn == "shared_ffn" else params
        h = apply_norm(fp["norm2"], x, cfg)
        y, aux = apply_ffn(fp["ffn"], h, cfg.ffn, gen=gen, train=train)
        x = x + dropout(gen, y, cfg.dropout, train)
    return x, aux, (new_cache or None), new_memory


def _cross_kv(cparams: Dict, enc_out: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's keys and values (B, S_enc, KV, D) of the
    encoder's output, in its dtype."""
    a = cfg.attention
    k = _split_heads(enc_out @ cparams["wk"].to(enc_out.dtype), a.n_kv_heads, a.head_dim)
    v = _split_heads(enc_out @ cparams["wv"].to(enc_out.dtype), a.n_kv_heads, a.head_dim)
    return k, v


def cross_kv_cache(cparams: Dict, enc_out: torch.Tensor, cfg: ModelConfig) -> Dict:
    """Precomputed encoder K/V for decode (whisper's prefill)."""
    k, v = _cross_kv(cparams, enc_out, cfg)
    return {"k": k, "v": v}


REMAT_MODES = ("none", "full", "dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(remat: str, gen: Optional[torch.Generator], fn,
                 x: torch.Tensor, memory: Optional[torch.Tensor]):
    """``fn(x, memory=memory)`` under ``torch.utils.checkpoint``
    (non-reentrant). The checkpoint restores only the default generators
    for the recomputation; ``gen``, from which the block draws dropout,
    expert dropout and gating noise, is set back to its state at the
    block's entry before the recomputation and to its state of just before
    it after, so that the recomputed block draws what the forward drew and
    later draws do not shift."""
    entry = gen.get_state() if gen is not None else None
    ran = [False]

    def body(x, memory):
        if not ran[0] or gen is None:
            ran[0] = True
            return fn(x, memory=memory)
        before = gen.get_state()
        gen.set_state(entry)
        try:
            return fn(x, memory=memory)
        finally:
            gen.set_state(before)

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_saveable)
    return ckpt.checkpoint(body, x, memory, use_reentrant=False, **kw)


def init_stack(gen: torch.Generator, cfg: ModelConfig, dtype, *,
               n_layers: Optional[int] = None, ep_degree: int = 0,
               device="cuda", cross: bool = False) -> Dict:
    params = {}
    if _needs_shared(cfg):
        params["shared"] = init_shared_block(gen, cfg, dtype, device)
    params["segments"] = [
        {f"e{ei}": [init_block(gen, cfg, entry, dtype, ep_degree, device, cross)
                    for _ in range(seg.repeats)]
         for ei, entry in enumerate(seg.entries)}
        for seg in plan_segments(cfg, n_layers)]
    return params


def _stack_cache(cfg: ModelConfig, make) -> Dict:
    return {"segments": [
        {f"e{ei}": [make(entry) for _ in range(seg.repeats)]
         for ei, entry in enumerate(seg.entries)}
        for seg in plan_segments(cfg)]}


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device="cuda") -> Dict:
    """Contiguous caches mirroring the stack: a KV cache for each attention
    slot (every shared slot its own), the conv and SSD state for each SSM
    layer."""
    def make(entry):
        if entry.mixer in ("attn", "shared_attn"):
            return {"self": init_attn_cache(cfg, batch, max_len, dtype, device)}
        if entry.mixer == "ssm":
            return {"ssm": init_ssm_cache(cfg, batch, device=device)}
        return {}
    return _stack_cache(cfg, make)


def init_paged_stack_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                           dtype, device="cuda") -> Dict:
    """Paged KV pools mirroring the stack structure (page 0 reserved); the
    per-request mapping lives in the block table passed to ``apply_stack``.
    SSM mixers have no paged form (as in the reference)."""
    def make(entry):
        if entry.mixer in ("attn", "shared_attn"):
            return {"self": init_attn_paged_cache(cfg, n_pages, page_size, dtype,
                                                  device)}
        if entry.mixer == "ssm":
            raise NotImplementedError("paged cache: ssm mixers unsupported")
        return {}
    return _stack_cache(cfg, make)


def apply_stack(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None, cache_index=None,
                block_table: Optional[torch.Tensor] = None,
                seq_lens=None, mems: Optional[Dict] = None,
                gen: Optional[torch.Generator] = None, train: bool = False,
                remat: str = "none", enc_out: Optional[torch.Tensor] = None,
                n_layers: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict, Optional[Dict], Optional[Dict]]:
    """Run every layer in order (the first ``n_layers`` of the pattern,
    all ``cfg.n_layers`` by default). Returns (x, aux, new_cache,
    new_mems). ``enc_out`` feeds the cross-attention of a decoder without
    cross caches. With ``remat`` "full" or "dots" and gradients on, each
    block is recomputed in the backward (``_remat_block``)."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat={remat!r}, not one of {REMAT_MODES}")
    recompute = remat != "none" and torch.is_grad_enabled()
    aux_tot: Dict[str, torch.Tensor] = {}
    new_cache = {"segments": []} if cache is not None else None
    new_mems = {"segments": []} if mems is not None else None
    shared = params.get("shared")
    for si, seg in enumerate(plan_segments(cfg, n_layers)):
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
                block = functools.partial(
                    apply_block, seg_params[f"e{ei}"][r], cfg=cfg, entry=entry,
                    positions=positions, cache=c, cache_index=cache_index,
                    block_table=block_table, seq_lens=seq_lens, gen=gen,
                    train=train, shared=shared, enc_out=enc_out)
                if recompute:
                    x, aux, nc, nm = _remat_block(remat, gen, block, x, m)
                else:
                    x, aux, nc, nm = block(x, memory=m)
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
