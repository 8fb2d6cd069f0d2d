"""Config dataclasses: the port's own copy of the reference's
``configs/base.py`` (model, FFN, attention and SSM fields, unchanged, so a
config built here equals the reference's field by field).

Everything is a frozen dataclass; ``cfg.override(**kw)`` and
``cfg.with_ffn(ffn)`` produce variants. Pure data: no torch import.
``FFN_KINDS`` and ``FFN_IMPLS`` are the reference's names; the port runs
every kind (``models/ffn.FFN_REGISTRY``) and every mixer (attention,
Mamba2's SSD, zamba2's shared block). ``ModelConfig.param_counts`` is the
reference's analytic count. ``OptimizerConfig`` is the reference's, for the
trainer (``runtime/steps``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

FFN_KINDS = ("dense", "glu", "topk", "pkm", "sigma_moe", "switch", "sbase",
             "noisy_topk", "none")

# The execution rung of an FFN (core/dispatch.py): "auto" defers to
# kernels.ops.default_impl; "pallas_fused" and "pallas" run the CUDA kernels
# (the "_interpret" names select the same rungs here); "ragged" and "ref"
# are the sort path's plain grouped matmuls; "einsum" the weighted value
# sum's plain gather; "dense" bypasses the planned layer (the oracle).
FFN_IMPLS = ("auto", "dense", "einsum", "ragged", "ref", "pallas",
             "pallas_interpret", "pallas_fused", "pallas_fused_interpret")


@dataclass(frozen=True)
class FFNConfig:
    """One feedforward block (the paper's subject); see the reference for
    the meaning of each kind."""
    kind: str = "dense"
    d_ff: int = 0                      # total d_ff (= G * n_experts for MoE)
    activation: str = "relu"           # relu | gelu | silu | softmax
    # --- MoE family ---
    n_experts: int = 0                 # N_E
    expert_size: int = 0               # G (group size); d_ff = G * N_E
    k: int = 0                         # top-K experts
    selector_activation: str = "sigmoid"   # sigmoid | softmax | softmax_pre_topk
    renormalize: bool = False          # re-normalize scores after top-K
    expert_dropout: float = 0.0
    reg_gamma: float = 0.0
    reg_kind: str = "entropy"          # entropy | switch | cv | none
    capacity_factor: float = 1.25
    dispatch: str = "einsum"           # einsum | sort  (sort == CVMM path)
    impl: str = "auto"                 # execution rung, see FFN_IMPLS
    sigma_moe_init: bool = True
    n_shared_experts: int = 0
    glu_experts: bool = False
    sinkhorn_iters: int = 8
    noise_std: float = 1.0
    # --- top-K activation ---
    topk_k: int = 0
    # --- PKM ---
    pkm_heads: int = 4
    pkm_knn: int = 32
    n_subkeys: int = 0                 # n_values = n_subkeys**2
    n_candidates: int = 0              # C of the two-stage top-C (0: C = K)

    @property
    def n_values(self) -> int:
        """PKM's value-table rows, derived from ``n_subkeys``."""
        return self.n_subkeys * self.n_subkeys

    @property
    def pkm_candidates(self) -> int:
        """C of the two-stage product-key top-K: the C*C candidate grid
        holds the true top-K when C >= K, so C defaults to ``pkm_knn``."""
        return self.n_candidates or self.pkm_knn

    def validate(self) -> None:
        assert self.kind in FFN_KINDS, self.kind
        assert self.impl in FFN_IMPLS, self.impl
        if self.kind in ("sigma_moe", "switch", "sbase", "noisy_topk"):
            assert self.n_experts > 0 and self.expert_size > 0 and self.k > 0
        if self.kind == "pkm":
            assert self.n_subkeys > 1
            assert self.d_ff in (0, self.n_values), \
                f"pkm d_ff={self.d_ff} != n_subkeys**2={self.n_values}"
            if self.n_candidates:
                assert self.n_candidates >= self.pkm_knn, (
                    f"pkm n_candidates={self.n_candidates} < pkm_knn="
                    f"{self.pkm_knn}: the C*C candidate grid holds the true "
                    f"top-K only when C >= K")
                assert self.n_candidates <= self.n_subkeys, (
                    f"pkm n_candidates={self.n_candidates} > n_subkeys="
                    f"{self.n_subkeys}: each half has only n_subkeys scores")
        if self.kind in ("dense", "glu", "topk"):
            assert self.d_ff > 0


def moe_ffn(n_experts: int, expert_size: int, k: int, **kw) -> FFNConfig:
    return FFNConfig(kind="sigma_moe", n_experts=n_experts,
                     expert_size=expert_size, k=k,
                     d_ff=n_experts * expert_size, **kw)


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int = 0
    n_kv_heads: int = 0                # GQA; == n_heads for MHA
    head_dim: int = 0
    rope_theta: float = 10000.0
    kind: str = "global"               # global | local (sliding window) | xl_rel
    window: int = 0
    causal: bool = True
    qk_norm: bool = False
    softmax_scale: Optional[float] = None
    kv_chunk: int = 2048               # chunked-attention KV chunk

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block config."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256                   # SSD chunk length
    n_groups: int = 1                  # B/C groups (like GQA for SSM)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class BlockSpecEntry:
    """One entry of a layer pattern: which mixer + which ffn."""
    mixer: str                          # "attn" | "ssm" | "shared_attn"
    ffn: str = "ffn"                    # "ffn" | "none" | "shared_ffn"
    attn_kind: str = ""                 # override attention kind


@dataclass(frozen=True)
class ModelConfig:
    name: str = ""
    family: str = "dense"
    n_layers: int = 0
    d_model: int = 0
    vocab_size: int = 0
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    ffn: FFNConfig = field(default_factory=FFNConfig)
    ssm: Optional[SSMConfig] = None
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dropout: float = 0.0
    max_seq_len: int = 131072
    dtype: str = "bfloat16"            # compute dtype
    param_dtype: str = "float32"       # master dtype
    pattern: Tuple[BlockSpecEntry, ...] = ()
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500
    n_vision_tokens: int = 0
    xl_memory: int = 0
    pos_encoding: str = "rope"         # rope | xl_rel | learned | none
    logit_softcap: float = 0.0
    subquadratic: bool = False

    def override(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def with_ffn(self, ffn: FFNConfig) -> "ModelConfig":
        return dataclasses.replace(self, ffn=ffn)

    def layer_pattern(self) -> List[BlockSpecEntry]:
        """Expanded per-layer pattern of length n_layers."""
        pattern = self.pattern or (BlockSpecEntry(mixer="attn", ffn="ffn"),)
        return [pattern[i % len(pattern)] for i in range(self.n_layers)]

    # ---- analytic parameter counts (the reference's) ----
    def ffn_params(self, ffn: Optional[FFNConfig] = None) -> Tuple[int, int]:
        """(total, active) parameter counts of one FFN block."""
        f = ffn or self.ffn
        d = self.d_model
        if f.kind == "none":
            return 0, 0
        if f.kind in ("dense", "topk"):
            p = 2 * d * f.d_ff
            # top-k still computes the full up-projection (paper Sec 3.1)
            active = (d * f.d_ff + d * (f.topk_k or f.d_ff) if f.kind == "topk"
                      else p)
            return p, active
        if f.kind == "glu":
            return 3 * d * f.d_ff, 3 * d * f.d_ff
        if f.kind == "pkm":
            p = 2 * f.n_subkeys * (d // 2) + f.n_values * d
            active = 2 * f.n_subkeys * (d // 2) + f.pkm_heads * f.pkm_knn * d
            return p, active
        per_expert = (3 if f.glu_experts else 2) * d * f.expert_size
        p = f.n_experts * per_expert + f.n_experts * d           # + router
        p += f.n_shared_experts * per_expert
        active = (f.k + f.n_shared_experts) * per_expert + f.n_experts * d
        return p, active

    def attn_params(self) -> int:
        a = self.attention
        d = self.d_model
        p = d * a.q_dim + 2 * d * a.kv_dim + a.q_dim * d
        if a.kind == "xl_rel":
            p += d * a.q_dim + 2 * a.q_dim       # W_r and the u/v biases
        return p

    def ssm_params(self) -> int:
        if self.ssm is None:
            return 0
        s = self.ssm
        d = self.d_model
        din = s.d_inner(d)
        nh = s.n_heads(d)
        # in_proj: x->(z, x, B, C, dt); conv; A, D, dt_bias; norm; out_proj
        conv_dim = din + 2 * s.n_groups * s.d_state
        in_proj = d * (2 * din + 2 * s.n_groups * s.d_state + nh)
        return in_proj + conv_dim * s.d_conv + 3 * nh + din + din * d

    def param_counts(self) -> Dict[str, int]:
        """Analytic totals, as the reference: {'total', 'active',
        'embedding', 'body', 'body_active'} (no norms, biases or learned
        position tables; a shared block counts once in 'total' and at every
        use in 'active')."""
        d = self.d_model
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        body_total = body_active = 0
        shared_attn_counted = shared_ffn_counted = False
        for entry in self.layer_pattern():
            if entry.mixer == "attn":
                body_total += self.attn_params()
                body_active += self.attn_params()
            elif entry.mixer == "shared_attn":
                if not shared_attn_counted:
                    body_total += self.attn_params()
                    shared_attn_counted = True
                body_active += self.attn_params()
            elif entry.mixer == "ssm":
                body_total += self.ssm_params()
                body_active += self.ssm_params()
            if entry.ffn == "ffn":
                t, a = self.ffn_params()
                body_total += t
                body_active += a
            elif entry.ffn == "shared_ffn":
                t, a = self.ffn_params()
                if not shared_ffn_counted:
                    body_total += t
                    shared_ffn_counted = True
                body_active += a
        if self.is_encoder_decoder:
            # encoder layers (self-attention + FFN) and decoder cross-attention
            enc = self.n_encoder_layers * (self.attn_params() + self.ffn_params()[0])
            cross = self.n_layers * self.attn_params()
            body_total += enc + cross
            body_active += enc + cross
        return {"total": emb + head + body_total, "active": head + body_active,
                "embedding": emb + head, "body": body_total,
                "body_active": body_active}


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 2.5e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.25
    schedule: str = "cosine"           # cosine | wsd | constant
    warmup_steps: int = 0
    total_steps: int = 100_000
    final_lr_ratio: float = 0.0
    grad_accum: int = 1
    grad_compression: str = "none"     # none | bf16 | int8  (error-feedback)
