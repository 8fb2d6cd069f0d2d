"""Decoder-only language model (the reference's ``models/lm.py``): init,
embedding, the training forward and loss (with Transformer-XL segment
memories), and prefill/decode on contiguous and paged KV caches for
serving. Encoder-decoder and vision prefixes are not ported yet.

Every entry point runs on the device of its inputs; ``LM.init`` takes an
explicit ``torch.Generator`` and ``device`` ("cuda" unless the caller asks
for the CPU).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..common import map_leaves, round_up
from ..configs.base import ModelConfig
from .layers import apply_norm, dropout, init_embedding, init_norm
from .stack import (apply_stack, init_mems, init_paged_stack_cache, init_stack,
                    init_stack_cache)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(logits / cap) if cap else logits


def _check_supported(cfg: ModelConfig) -> None:
    """What the port runs so far: decoder-only attention+FFN stacks with
    RoPE, no positional encoding, or (for training) XL relative attention."""
    if cfg.is_encoder_decoder or cfg.n_vision_tokens:
        raise NotImplementedError("encoder-decoder and vision models are not "
                                  "ported yet")
    if cfg.pos_encoding not in ("rope", "none", "xl_rel"):
        raise NotImplementedError(
            f"pos_encoding={cfg.pos_encoding!r} is not ported yet")


def _check_serving(cfg: ModelConfig) -> None:
    """KV caches take per-request offsets, which need RoPE or no positional
    encoding; XL models train on segment memories instead."""
    if cfg.pos_encoding not in ("rope", "none") or cfg.attention.kind == "xl_rel":
        raise NotImplementedError(
            f"pos_encoding={cfg.pos_encoding!r}: KV-cache serving needs RoPE "
            "or no positional encoding")


class LM:
    def __init__(self, cfg: ModelConfig):
        _check_supported(cfg)
        self.cfg = cfg
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
             "stack": init_stack(gen, cfg, self.param_dtype, device=device)}
        if not cfg.tie_embeddings:
            p["unembed"] = init_embedding(gen, cfg.d_model, self.vocab_padded,
                                          self.param_dtype,
                                          device) * (cfg.d_model ** -0.5)
        return p

    def serving_params(self, params: Dict) -> Dict:
        """Cast every weight that the model casts to the compute dtype at its
        use (projections, router, experts, embeddings) once, up front; norm
        scales stay in their own dtype because norms read them in float32.
        The forward then gives the same numbers as from the master params,
        without reading them in float32 on every call."""
        def cast(path, t):
            is_norm = any(str(k).startswith("norm")
                          or k in ("final_norm", "q_scale", "k_scale")
                          for k in path)
            return t if is_norm or not t.is_floating_point() else t.to(self.dtype)
        return map_leaves(params, cast)

    # -------------------------------------------------------------- embedding
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["emb"].to(self.dtype)[tokens]

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

    def forward(self, params, tokens: torch.Tensor, *,
                gen: Optional[torch.Generator] = None, train: bool = False,
                mems: Optional[Dict] = None):
        """Full-sequence forward -> (hidden after the final norm, aux,
        new_mems). Dropout draws from ``gen``."""
        x = dropout(gen, self._embed(params, tokens), self.cfg.dropout, train)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux, _, new_mems = apply_stack(params["stack"], x, self.cfg,
                                          positions=positions, mems=mems,
                                          gen=gen, train=train)
        return apply_norm(params["final_norm"], x, self.cfg), aux, new_mems

    def loss(self, params, batch: Dict, *, gen: Optional[torch.Generator] = None,
             train: bool = True, mems: Optional[Dict] = None):
        """Next-token cross-entropy plus the MoE regularizers.
        batch["tokens"] (B, S); labels are the tokens shifted by one.
        Returns (loss, metrics), or (loss, (metrics, new_mems)) with mems."""
        from ..runtime.loss import chunked_cross_entropy
        cfg = self.cfg
        tokens = batch["tokens"]
        h, aux, new_mems = self.forward(params, tokens, gen=gen, train=train,
                                        mems=mems)
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
        _check_serving(self.cfg)
        return init_stack_cache(self.cfg, batch, max_len, self.dtype, device)

    def prefill(self, params, tokens: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """Run prompts (B, S) through the stack into a contiguous cache;
        returns (last-position logits (B, V), cache)."""
        x = self._embed(params, tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, new_cache, _ = apply_stack(params["stack"], x, self.cfg,
                                         positions=positions, cache=cache,
                                         cache_index=0)
        x = apply_norm(params["final_norm"], x[:, -1:, :], self.cfg)
        return self._unembed(params, x)[:, 0], new_cache

    def decode_step(self, params, cache: Dict, token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Dict]:
        """One batched decode step on a contiguous cache: token (B,), pos an
        int shared by all rows."""
        x = self._embed(params, token[:, None])
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
        _check_serving(self.cfg)
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
