"""Config dataclasses: the port's own copy of the reference's
``configs/base.py`` (model, FFN, attention and SSM fields, unchanged, so a
config built here equals the reference's field by field).

Everything is a frozen dataclass; ``cfg.override(**kw)`` and
``cfg.with_ffn(ffn)`` produce variants. Pure data: no torch import.
``FFN_KINDS`` and ``FFN_IMPLS`` are the reference's names; the port runs
the kinds in ``models/ffn.FFN_REGISTRY`` that do not raise, and only
attention mixers. ``OptimizerConfig`` is the reference's, for the trainer
(``runtime/steps``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

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
    ssm: Optional[object] = None       # SSM mixers are not ported yet
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
