"""Atomic, asynchronous checkpoints of the training state."""
from .manager import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "load_pytree", "save_pytree"]
