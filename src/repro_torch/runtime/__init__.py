"""Training runtime: the loss, the train and eval steps (on one device or
a mesh of ranks), and the straggler monitor."""
from .loss import chunked_cross_entropy
from .monitor import StragglerMonitor
from .steps import (init_train_state, make_decode_step, make_eval_step,
                    make_prefill_step, make_train_step)

__all__ = ["StragglerMonitor", "chunked_cross_entropy", "init_train_state",
           "make_decode_step", "make_eval_step", "make_prefill_step",
           "make_train_step"]
