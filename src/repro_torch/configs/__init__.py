from .archs import get_config, reduced
from .base import (AttentionConfig, BlockSpecEntry, FFNConfig, ModelConfig,
                   OptimizerConfig, moe_ffn)

__all__ = ["AttentionConfig", "BlockSpecEntry", "FFNConfig", "ModelConfig",
           "OptimizerConfig", "get_config", "moe_ffn", "reduced"]
