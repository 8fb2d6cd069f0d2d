from .archs import get_config, reduced
from .base import AttentionConfig, BlockSpecEntry, FFNConfig, ModelConfig, moe_ffn

__all__ = ["AttentionConfig", "BlockSpecEntry", "FFNConfig", "ModelConfig",
           "get_config", "moe_ffn", "reduced"]
