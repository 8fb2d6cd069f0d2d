from .lm import LM
from .registry import build_model

__all__ = ["LM", "build_model"]
