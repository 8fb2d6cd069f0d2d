"""The architectures the port runs, and ``reduced()`` smoke variants: a
copy of the reference's ``configs/archs.py``. The ten assigned
architectures (``ASSIGNED_ARCHS``: dense, MoE, SSM, hybrid, vision-prefix
and encoder-decoder models from the public literature) and the paper's six
configs (Tab. 8/9), its parameter-equal dense/sigma-MoE pairs on
WikiText-103 (47M, 262M) and enwik8 (41M)."""
from __future__ import annotations

from typing import Callable, Dict

from .base import (AttentionConfig, BlockSpecEntry, FFNConfig, ModelConfig, SSMConfig,
                   moe_ffn)

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    return sorted(_REGISTRY)


@register("mamba2-370m")
def mamba2_370m() -> ModelConfig:
    """[ssm] SSD (state-space duality), attention-free. arXiv:2405.21060."""
    return ModelConfig(
        name="mamba2-370m", family="ssm", n_layers=48, d_model=1024,
        vocab_size=50280, norm="rmsnorm", pos_encoding="none",
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
        ffn=FFNConfig(kind="none"),
        pattern=(BlockSpecEntry(mixer="ssm", ffn="none"),),
        tie_embeddings=True, subquadratic=True,
    )


@register("granite-moe-3b-a800m")
def granite_moe() -> ModelConfig:
    """[moe] IBM granite 3.0 MoE: 40 experts, top-8, GLU experts. hf:ibm-granite."""
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
        vocab_size=49155,
        attention=AttentionConfig(n_heads=24, n_kv_heads=8, head_dim=64),
        ffn=moe_ffn(n_experts=40, expert_size=512, k=8,
                    selector_activation="softmax", renormalize=True,
                    glu_experts=True, reg_kind="switch", reg_gamma=0.01,
                    dispatch="einsum"),
        tie_embeddings=True,
    )


@register("llama4-scout-17b-a16e")
def llama4_scout() -> ModelConfig:
    """[moe] MoE 16 experts top-1 + shared expert, early fusion. hf:meta-llama."""
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
        vocab_size=202048,
        attention=AttentionConfig(n_heads=40, n_kv_heads=8, head_dim=128,
                                  rope_theta=500000.0),
        ffn=moe_ffn(n_experts=16, expert_size=8192, k=1,
                    selector_activation="sigmoid", glu_experts=True,
                    n_shared_experts=1, reg_kind="switch", reg_gamma=0.01,
                    dispatch="einsum"),
    )


@register("pixtral-12b")
def pixtral_12b() -> ModelConfig:
    """[vlm] pixtral-ViT frontend (STUB: precomputed patch embeddings) + mistral-nemo
    backbone. hf:mistralai/Pixtral-12B-2409."""
    return ModelConfig(
        name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
        vocab_size=131072,
        attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                                  rope_theta=1e6),
        ffn=FFNConfig(kind="glu", d_ff=14336, activation="silu"),
        n_vision_tokens=256,    # stub: one 256-token image prefix
    )


@register("zamba2-7b")
def zamba2_7b() -> ModelConfig:
    """[hybrid] Mamba2 backbone + shared attention+MLP block applied periodically.
    arXiv:2411.15242. 81 layer slots; every 6th slot applies the *shared* block."""
    pat = tuple(
        [BlockSpecEntry(mixer="ssm", ffn="none")] * 5
        + [BlockSpecEntry(mixer="shared_attn", ffn="shared_ffn")]
    )
    return ModelConfig(
        name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
        vocab_size=32000,
        attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=112),
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
        ffn=FFNConfig(kind="glu", d_ff=14336, activation="gelu"),
        pattern=pat, tie_embeddings=True, subquadratic=True,
    )


@register("deepseek-coder-33b")
def deepseek_coder_33b() -> ModelConfig:
    """[dense] llama-arch. arXiv:2401.14196."""
    return ModelConfig(
        name="deepseek-coder-33b", family="dense", n_layers=62, d_model=7168,
        vocab_size=32256,
        attention=AttentionConfig(n_heads=56, n_kv_heads=8, head_dim=128,
                                  rope_theta=100000.0),
        ffn=FFNConfig(kind="glu", d_ff=19200, activation="silu"),
    )


@register("llama3-8b")
def llama3_8b() -> ModelConfig:
    """[dense] GQA, 128k vocab. arXiv:2407.21783."""
    return ModelConfig(
        name="llama3-8b", family="dense", n_layers=32, d_model=4096,
        vocab_size=128256,
        attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                                  rope_theta=500000.0),
        ffn=FFNConfig(kind="glu", d_ff=14336, activation="silu"),
    )


@register("gemma3-27b")
def gemma3_27b() -> ModelConfig:
    """[dense] 5:1 local:global attention, 128k ctx. hf:google/gemma-3."""
    pat = tuple(
        [BlockSpecEntry(mixer="attn", ffn="ffn", attn_kind="local")] * 5
        + [BlockSpecEntry(mixer="attn", ffn="ffn", attn_kind="global")]
    )
    return ModelConfig(
        name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
        vocab_size=262144,
        attention=AttentionConfig(n_heads=32, n_kv_heads=16, head_dim=128,
                                  window=1024, qk_norm=True),
        ffn=FFNConfig(kind="glu", d_ff=21504, activation="gelu"),
        pattern=pat, tie_embeddings=True, logit_softcap=30.0,
    )


@register("minicpm-2b")
def minicpm_2b() -> ModelConfig:
    """[dense] WSD schedule, llama-like arch. arXiv:2404.06395."""
    return ModelConfig(
        name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
        vocab_size=122753,
        attention=AttentionConfig(n_heads=36, n_kv_heads=36, head_dim=64),
        ffn=FFNConfig(kind="glu", d_ff=5760, activation="silu"),
        tie_embeddings=True,
    )


@register("whisper-tiny")
def whisper_tiny() -> ModelConfig:
    """[audio] enc-dec; conv frontend STUBBED (precomputed frame embeddings).
    arXiv:2212.04356."""
    return ModelConfig(
        name="whisper-tiny", family="audio", n_layers=4, d_model=384,
        vocab_size=51865, norm="layernorm", pos_encoding="learned",
        attention=AttentionConfig(n_heads=6, n_kv_heads=6, head_dim=64),
        ffn=FFNConfig(kind="dense", d_ff=1536, activation="gelu"),
        is_encoder_decoder=True, n_encoder_layers=4, n_audio_frames=1500,
        max_seq_len=32768 + 8, tie_embeddings=True,
    )


def _paper_base(d_model, d_ff, n_layers, n_heads, head_dim, ctx, vocab) -> ModelConfig:
    return ModelConfig(
        name="paper", family="dense", n_layers=n_layers, d_model=d_model,
        vocab_size=vocab, norm="layernorm", pos_encoding="xl_rel",
        attention=AttentionConfig(n_heads=n_heads, n_kv_heads=n_heads,
                                  head_dim=head_dim, kind="xl_rel"),
        ffn=FFNConfig(kind="dense", d_ff=d_ff, activation="relu"),
        xl_memory=ctx, max_seq_len=4 * ctx, dropout=0.1,
    )


@register("wt103-47m-dense")
def wt103_small_dense() -> ModelConfig:
    # Tab. 8 row 1: 47M, d_model 412, d_ff 2053, 16L, 10H, head 41, ctx 256, SP vocab.
    return _paper_base(412, 2053, 16, 10, 41, 256, 8000).override(name="wt103-47m-dense")


@register("wt103-47m-moe")
def wt103_small_moe() -> ModelConfig:
    # Tab. 9: N_E=16, G=128, K=4, gamma=1e-3, no expert dropout.
    base = wt103_small_dense()
    return base.with_ffn(moe_ffn(16, 128, 4, reg_gamma=1e-3, reg_kind="entropy",
                                 dispatch="sort")).override(name="wt103-47m-moe")


@register("wt103-262m-dense")
def wt103_big_dense() -> ModelConfig:
    return _paper_base(1024, 4110, 18, 16, 64, 512, 8000).override(
        name="wt103-262m-dense", dropout=0.2)


@register("wt103-262m-moe")
def wt103_big_moe() -> ModelConfig:
    base = wt103_big_dense()
    return base.with_ffn(moe_ffn(32, 128, 4, expert_dropout=0.2, reg_gamma=1e-3,
                                 reg_kind="entropy", dispatch="sort")).override(
        name="wt103-262m-moe")


@register("enwik8-41m-dense")
def enwik8_dense() -> ModelConfig:
    return _paper_base(512, 2053, 12, 8, 64, 512, 256).override(name="enwik8-41m-dense")


@register("enwik8-41m-moe")
def enwik8_moe() -> ModelConfig:
    base = enwik8_dense()
    return base.with_ffn(moe_ffn(16, 128, 4, expert_dropout=0.05, reg_gamma=1e-4,
                                 reg_kind="entropy", dispatch="sort")).override(
        name="enwik8-41m-moe")


def reduced(name: str) -> ModelConfig:
    """A tiny config of the same family as ``name`` for CPU smoke tests (the
    reference's rules)."""
    cfg = get_config(name)
    kw = dict(
        n_layers=min(cfg.n_layers, 3 if not cfg.pattern else len(cfg.pattern)),
        d_model=64, vocab_size=256, max_seq_len=512,
    )
    if cfg.attention.n_heads:
        kw["attention"] = AttentionConfig(
            n_heads=4,
            n_kv_heads=2 if cfg.attention.n_kv_heads < cfg.attention.n_heads else 4,
            head_dim=16, kind=cfg.attention.kind, window=32,
            qk_norm=cfg.attention.qk_norm, kv_chunk=64)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32)
    f = cfg.ffn
    if f.kind in ("sigma_moe", "switch", "sbase", "noisy_topk"):
        kw["ffn"] = moe_ffn(4, 32, min(f.k, 2),
                            selector_activation=f.selector_activation,
                            renormalize=f.renormalize, glu_experts=f.glu_experts,
                            n_shared_experts=f.n_shared_experts, reg_kind=f.reg_kind,
                            reg_gamma=f.reg_gamma, dispatch="sort")
    elif f.kind in ("dense", "glu"):
        kw["ffn"] = FFNConfig(kind=f.kind, d_ff=128, activation=f.activation)
    elif f.kind == "pkm":
        kw["ffn"] = FFNConfig(kind="pkm", n_subkeys=8, pkm_heads=2, pkm_knn=4)
    if cfg.is_encoder_decoder:
        kw["n_encoder_layers"] = 2
        kw["n_audio_frames"] = 32
    if cfg.n_vision_tokens:
        kw["n_vision_tokens"] = 8
    if cfg.xl_memory:
        kw["xl_memory"] = 32
    return cfg.override(**kw)


ASSIGNED_ARCHS = [
    "mamba2-370m", "granite-moe-3b-a800m", "llama4-scout-17b-a16e", "pixtral-12b",
    "zamba2-7b", "deepseek-coder-33b", "llama3-8b", "gemma3-27b", "minicpm-2b",
    "whisper-tiny",
]
