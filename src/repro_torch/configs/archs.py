"""The architectures the port runs, and ``reduced()`` smoke variants: a
copy of the reference's ``configs/archs.py`` entries. granite-moe is the
serving slice's model; the paper's six configs (Tab. 8/9), its
parameter-equal dense/sigma-MoE pairs on WikiText-103 (47M, 262M) and
enwik8 (41M), are the training slice's."""
from __future__ import annotations

from typing import Callable, Dict

from .base import AttentionConfig, FFNConfig, ModelConfig, moe_ffn

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
    reference's rules for the families registered here)."""
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
    if cfg.xl_memory:
        kw["xl_memory"] = 32
    return cfg.override(**kw)
