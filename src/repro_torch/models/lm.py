"""Language model (the reference's ``models/lm.py``): decoder-only
(dense, MoE, SSM, hybrid, vision prefix) and encoder-decoder (whisper) in
one class. Init, embedding, the training forward and loss (with
Transformer-XL segment memories), and prefill/decode on contiguous and
paged KV caches for serving.

The contiguous cache serves every model: RoPE, learned positions (read at
the decode position) or none, SSM states, and whisper's cross-attention
caches made at prefill. The paged pool serves RoPE and position-free
decoder-only models, as the reference's does.

Every entry point runs on the device of its inputs; ``LM.init`` takes an
explicit ``torch.Generator`` and ``device`` ("cuda" unless the caller asks
for the CPU).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..common import map_leaves, round_up
from ..configs.base import BlockSpecEntry, ModelConfig
from .layers import apply_norm, dropout, init_embedding, init_norm, learned_positions
from .stack import (apply_stack, cross_kv_cache, init_mems, init_paged_stack_cache,
                    init_stack, init_stack_cache)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# Leaves (or subtrees) that the model reads in float32 whatever the
# compute dtype: norms, and the SSM's gated-norm scale, A, D and dt bias.
_READ_IN_F32 = frozenset({"final_norm", "enc_norm", "q_scale", "k_scale", "scale",
                          "A_log", "D", "dt_bias"})


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(logits / cap) if cap else logits


def _check_contiguous(cfg: ModelConfig) -> None:
    """XL models train on segment memories; they have no KV-cache serving."""
    if cfg.pos_encoding == "xl_rel" or cfg.attention.kind == "xl_rel":
        raise NotImplementedError(
            "pos_encoding='xl_rel': KV-cache serving needs RoPE, learned or no "
            "positional encoding")


def _check_paged(cfg: ModelConfig) -> None:
    """The reference's ``_check_paged_support``: per-request offsets need
    position-free embeddings, and the pool holds no encoder or prefix."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError("paged serving: encoder-decoder models unsupported")
    if cfg.pos_encoding not in ("rope", "none") or cfg.attention.kind == "xl_rel":
        raise NotImplementedError(
            f"paged serving: pos_encoding={cfg.pos_encoding!r} unsupported"
            " (per-request offsets need position-free embeddings)")
    if cfg.n_vision_tokens:
        raise NotImplementedError("paged serving: vision prefix unsupported")


class LM:
    def __init__(self, cfg: ModelConfig, *, remat: str = "none", ep_degree: int = 0):
        """``remat``: "none", "full" or "dots", the training forward's
        recomputation of each block in the backward (``models/stack.py``);
        ``ep_degree``: the expert count is padded to a multiple of it."""
        self.cfg = cfg
        self.remat = remat
        self.ep_degree = ep_degree
        self.dtype = _DTYPES[cfg.dtype]
        self.param_dtype = _DTYPES[cfg.param_dtype]
        # vocab padded to a multiple of 512, as in the reference; padded
        # logit columns are masked wherever they can leak out.
        self.vocab_padded = round_up(cfg.vocab_size, 512)

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, device="cuda") -> Dict:
        """Master parameters in ``param_dtype``, drawn from ``gen``."""
        cfg = self.cfg
        p = {"emb": init_embedding(gen, self.vocab_padded, cfg.d_model,
                                   self.param_dtype, device),
             "final_norm": init_norm(cfg, cfg.d_model, self.param_dtype, device),
             "stack": init_stack(gen, cfg, self.param_dtype, ep_degree=self.ep_degree,
                                 device=device, cross=cfg.is_encoder_decoder)}
        if not cfg.tie_embeddings:
            p["unembed"] = init_embedding(gen, cfg.d_model, self.vocab_padded,
                                          self.param_dtype,
                                          device) * (cfg.d_model ** -0.5)
        if cfg.pos_encoding == "learned":
            p["pos_emb"] = 0.01 * torch.randn((cfg.max_seq_len, cfg.d_model), generator=gen,
                                              dtype=self.param_dtype, device=device)
        if cfg.is_encoder_decoder:
            p["enc_stack"] = init_stack(gen, self._encoder_cfg(), self.param_dtype,
                                        n_layers=cfg.n_encoder_layers, device=device)
            p["enc_norm"] = init_norm(cfg, cfg.d_model, self.param_dtype, device)
            p["enc_pos"] = 0.01 * torch.randn((cfg.n_audio_frames, cfg.d_model),
                                              generator=gen, dtype=self.param_dtype,
                                              device=device)
        return p

    def _encoder_cfg(self) -> ModelConfig:
        """The encoder: the decoder's widths, non-causal self-attention."""
        return self.cfg.override(
            pattern=(BlockSpecEntry(mixer="attn", ffn="ffn", attn_kind="noncausal"),),
            pos_encoding="learned")

    def serving_params(self, params: Dict) -> Dict:
        """Cast every weight that the model casts to the compute dtype at its
        use (projections, router, experts, embeddings) once, up front; norm
        scales and the SSM's decay, skip and step parameters stay in their
        own dtype because the model reads them in float32.
        The forward then gives the same numbers as from the master params,
        without reading them in float32 on every call."""
        def cast(path, t):
            keep = any(str(k).startswith("norm") or k in _READ_IN_F32 for k in path)
            return t if keep or not t.is_floating_point() else t.to(self.dtype)
        return map_leaves(params, cast)

    # -------------------------------------------------------------- embedding
    def _embed(self, params, tokens: torch.Tensor, *,
               prefix_embeds: Optional[torch.Tensor] = None,
               pos_offset: int = 0) -> torch.Tensor:
        """Token embeddings, plus learned positions from ``pos_offset``,
        after a vision prefix (B, P, d) if one is given."""
        x = params["emb"].to(self.dtype)[tokens]
        if self.cfg.pos_encoding == "learned":
            x = x + learned_positions(params["pos_emb"], pos_offset, tokens.shape[1],
                                      self.dtype)[None]
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(self.dtype), x], dim=1)
        return x

    def _unembed(self, params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        w = params["emb"].T if cfg.tie_embeddings else params["unembed"]
        logits = _softcap((h @ w.to(h.dtype)).float(), cfg.logit_softcap)
        if self.vocab_padded != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = -1e30
        return logits

    # ------------------------------------------------------------------ train
    def init_mems(self, batch: int, device="cuda") -> Dict:
        """Zero XL segment memories in the compute dtype."""
        return init_mems(self.cfg, batch, self.dtype, device)

    def _encode(self, params, frames: torch.Tensor, *,
                gen: Optional[torch.Generator] = None, train: bool = False):
        """Whisper's encoder over precomputed frame embeddings (B, F, d)."""
        cfg = self.cfg
        x = frames.to(self.dtype) + params["enc_pos"].to(self.dtype)[None]
        x, aux, _, _ = apply_stack(params["enc_stack"], x, self._encoder_cfg(), gen=gen,
                                   train=train, remat=self.remat,
                                   n_layers=cfg.n_encoder_layers)
        return apply_norm(params["enc_norm"], x, cfg), aux

    def forward(self, params, tokens: torch.Tensor, *,
                prefix_embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None, train: bool = False,
                mems: Optional[Dict] = None):
        """Full-sequence forward -> (hidden after the final norm, aux,
        new_mems); the hidden rows of a vision prefix come first. Dropout
        draws from ``gen``."""
        cfg = self.cfg
        x = dropout(gen, self._embed(params, tokens, prefix_embeds=prefix_embeds),
                    cfg.dropout, train)
        enc_out, aux_e = None, {}
        if cfg.is_encoder_decoder:
            enc_out, aux_e = self._encode(params, frames, gen=gen, train=train)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux, _, new_mems = apply_stack(params["stack"], x, cfg,
                                          positions=positions, mems=mems, gen=gen,
                                          train=train, remat=self.remat, enc_out=enc_out)
        for key, val in aux_e.items():
            aux[key] = aux.get(key, 0.0) + val
        return apply_norm(params["final_norm"], x, cfg), aux, new_mems

    def loss(self, params, batch: Dict, *, gen: Optional[torch.Generator] = None,
             train: bool = True, mems: Optional[Dict] = None):
        """Next-token cross-entropy plus the MoE regularizers.
        batch["tokens"] (B, S), and batch["patches"] (B, P, d) for a vision
        prefix (unsupervised) or batch["frames"] for the encoder; labels are
        the tokens shifted by one. Returns (loss, metrics), or (loss,
        (metrics, new_mems)) with mems."""
        from ..runtime.loss import chunked_cross_entropy
        cfg = self.cfg
        tokens = batch["tokens"]
        prefix = batch.get("patches")
        h, aux, new_mems = self.forward(params, tokens, prefix_embeds=prefix,
                                        frames=batch.get("frames"), gen=gen,
                                        train=train, mems=mems)
        h = h[:, 0 if prefix is None else prefix.shape[1]:]
        w = params["emb"].T if cfg.tie_embeddings else params["unembed"]
        ce, n_tok = chunked_cross_entropy(
            h[:, :-1], w.to(h.dtype), tokens[:, 1:], softcap=cfg.logit_softcap,
            n_valid_vocab=(cfg.vocab_size
                           if self.vocab_padded != cfg.vocab_size else 0))
        zero = torch.zeros((), device=h.device)
        reg = aux.get("moe_reg", zero)
        metrics = {"ce": ce, "moe_reg": reg,
                   "moe_dropped": aux.get("moe_dropped", zero), "tokens": n_tok}
        loss = ce + reg
        return loss, (metrics if mems is None else (metrics, new_mems))

    # ---------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int, device="cuda") -> Dict:
        _check_contiguous(self.cfg)
        return init_stack_cache(self.cfg, batch, max_len, self.dtype, device)

    def prefill(self, params, tokens: torch.Tensor, cache: Dict, *,
                patches: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
        """Run prompts (B, S) through the stack into a contiguous cache,
        after a vision prefix ``patches`` (B, P, d), and for an
        encoder-decoder model with the encoder's output of ``frames``
        (B, F, d) in every layer's cross cache; returns (last-position
        logits (B, V), cache). Decoding then starts at position P + S."""
        cfg = self.cfg
        x = self._embed(params, tokens, prefix_embeds=patches)
        if cfg.is_encoder_decoder:
            enc_out, _ = self._encode(params, frames)
            self._attach_cross_caches(params, cache, enc_out)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, new_cache, _ = apply_stack(params["stack"], x, cfg,
                                         positions=positions, cache=cache,
                                         cache_index=0)
        x = apply_norm(params["final_norm"], x[:, -1:, :], cfg)
        return self._unembed(params, x)[:, 0], new_cache

    def _attach_cross_caches(self, params, cache: Dict, enc_out: torch.Tensor) -> None:
        """Each decoder layer's cross-attention K/V of ``enc_out``, into its
        cache entry (whisper)."""
        for seg_params, seg_cache in zip(params["stack"]["segments"], cache["segments"]):
            for name, layers in seg_params.items():
                for p, c in zip(layers, seg_cache[name]):
                    if "cross" in p:
                        c["cross"] = cross_kv_cache(p["cross"], enc_out, self.cfg)

    def decode_step(self, params, cache: Dict, token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Dict]:
        """One batched decode step on a contiguous cache: token (B,), pos an
        int shared by all rows (learned positions read row ``pos``)."""
        x = self._embed(params, token[:, None], pos_offset=pos)
        positions = torch.full((token.shape[0], 1), pos, device=x.device)
        x, _, new_cache, _ = apply_stack(params["stack"], x, self.cfg,
                                         positions=positions, cache=cache,
                                         cache_index=pos)
        x = apply_norm(params["final_norm"], x, self.cfg)
        return self._unembed(params, x)[:, 0], new_cache

    # --------------------------------------------------------- paged serving
    def init_paged_cache(self, n_pages: int, page_size: int,
                         device="cuda") -> Dict:
        """Paged KV pool shared by all requests; page 0 is reserved."""
        _check_paged(self.cfg)
        return init_paged_stack_cache(self.cfg, n_pages, page_size,
                                      self.dtype, device)

    def prefill_paged(self, params, tokens: torch.Tensor, cache: Dict,
                      block_table: torch.Tensor, start: int,
                      length: int) -> Tuple[torch.Tensor, Dict]:
        """Prefill ONE request's chunk into the paged pool: tokens (1, S)
        padded chunk, block_table (1, n_blocks), ``start`` its absolute
        offset, ``length`` its valid tokens. Returns (logits at the last
        valid token (1, V), cache)."""
        x = self._embed(params, tokens)
        positions = start + torch.arange(tokens.shape[1], device=x.device)
        x, _, new_cache, _ = apply_stack(params["stack"], x, self.cfg,
                                         positions=positions, cache=cache,
                                         cache_index=start,
                                         block_table=block_table,
                                         seq_lens=length)
        last = x[:, max(length - 1, 0):max(length - 1, 0) + 1]
        last = apply_norm(params["final_norm"], last, self.cfg)
        return self._unembed(params, last)[:, 0], new_cache

    def decode_step_paged(self, params, cache: Dict, token: torch.Tensor,
                          positions: torch.Tensor, block_tables: torch.Tensor
                          ) -> Tuple[torch.Tensor, Dict]:
        """One batched paged decode step: token (B,), positions (B,)
        absolute per-request positions, block_tables (B, n_blocks)."""
        x = self._embed(params, token[:, None])
        x, _, new_cache, _ = apply_stack(params["stack"], x, self.cfg,
                                         positions=positions[:, None], cache=cache,
                                         cache_index=positions,
                                         block_table=block_tables)
        x = apply_norm(params["final_norm"], x, self.cfg)
        return self._unembed(params, x)[:, 0], new_cache
