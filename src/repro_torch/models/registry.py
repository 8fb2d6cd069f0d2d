"""Model builder: arch name / ModelConfig -> LM instance."""
from __future__ import annotations

from typing import Union

from ..configs.archs import get_config
from ..configs.base import ModelConfig
from .lm import LM


def build_model(cfg_or_name: Union[str, ModelConfig], **overrides) -> LM:
    cfg = (get_config(cfg_or_name) if isinstance(cfg_or_name, str)
           else cfg_or_name)
    if overrides:
        cfg = cfg.override(**overrides)
    return LM(cfg)
