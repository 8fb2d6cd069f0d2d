"""Training runtime: the loss and the single-device train step."""
from .loss import chunked_cross_entropy
from .steps import init_train_state, make_train_step

__all__ = ["chunked_cross_entropy", "init_train_state", "make_train_step"]
