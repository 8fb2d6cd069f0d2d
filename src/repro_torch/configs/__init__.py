from .archs import ASSIGNED_ARCHS, get_config, list_archs, reduced
from .base import (AttentionConfig, BlockSpecEntry, FFNConfig, ModelConfig,
                   OptimizerConfig, SSMConfig, moe_ffn)

__all__ = ["ASSIGNED_ARCHS", "AttentionConfig", "BlockSpecEntry", "FFNConfig",
           "ModelConfig", "OptimizerConfig", "SSMConfig", "get_config", "list_archs",
           "moe_ffn", "reduced"]
