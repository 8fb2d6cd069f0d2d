"""Arch name or ModelConfig -> LM instance (the reference's
``models/registry.py``)."""
from __future__ import annotations

from typing import Optional, Union

from ..configs.archs import get_config
from ..configs.base import FFNConfig, ModelConfig, moe_ffn
from .lm import LM


def build_model(cfg_or_name: Union[str, ModelConfig], *, remat: str = "none",
                ep_degree: int = 0, ffn: Optional[str] = None, **overrides) -> LM:
    """The LM of an arch name or config, with ``overrides`` applied and, if
    ``ffn`` names another kind, its FFN swapped by the reference's widths
    rule (parameter-matched: G * N_E = d_ff for sigma_moe, with the
    reference's capacity dispatch). ``remat`` is the reference's ("none",
    "full" or "dots"); ``ep_degree`` (the mesh's "model" axis) pads the
    expert count to a multiple of it. Its sequence-parallel and chunked-CE
    options are not ported."""
    cfg = (get_config(cfg_or_name) if isinstance(cfg_or_name, str)
           else cfg_or_name)
    if overrides:
        cfg = cfg.override(**overrides)
    if ffn is not None and ffn != cfg.ffn.kind:
        d_ff = cfg.ffn.d_ff or 4 * cfg.d_model
        if ffn == "sigma_moe":
            g = 128 if d_ff % 128 == 0 else max(64, d_ff // 16)
            ne = max(2, d_ff // g)
            cfg = cfg.with_ffn(moe_ffn(ne, g, max(1, min(4, ne // 2)),
                                       glu_experts=cfg.ffn.kind == "glu",
                                       reg_gamma=1e-3, reg_kind="entropy"))
        elif ffn == "topk":
            cfg = cfg.with_ffn(FFNConfig(kind="topk", d_ff=d_ff,
                                         topk_k=max(64, d_ff // 8)))
        elif ffn == "pkm":
            ns = max(4, int(d_ff ** 0.5))
            # each half has only n_subkeys scores, so K (and C, which
            # defaults to K) clamps to it on reduced configs
            knn = min(FFNConfig.pkm_knn, ns)
            cfg = cfg.with_ffn(FFNConfig(kind="pkm", n_subkeys=ns, pkm_knn=knn))
        elif ffn in ("dense", "glu"):
            cfg = cfg.with_ffn(FFNConfig(kind=ffn, d_ff=d_ff,
                                         activation=cfg.ffn.activation or "relu"))
        else:
            raise ValueError(f"cannot swap ffn to {ffn}")
    return LM(cfg, remat=remat, ep_degree=ep_degree)
