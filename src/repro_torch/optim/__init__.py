"""The reference's optimizer pieces: AdamW with float32 master weights,
global-norm clipping, learning-rate schedules and error-feedback gradient
compression."""
from .adamw import OptState, adamw_init, adamw_update
from .clip import clip_by_global_norm, global_norm
from .compress import (EXPERT_PARAM_NAMES, compress_grads, compress_pod_grads,
                       init_compression_state, is_expert_leaf)
from .schedule import make_schedule

__all__ = ["EXPERT_PARAM_NAMES", "OptState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "compress_grads", "compress_pod_grads",
           "global_norm", "init_compression_state", "is_expert_leaf",
           "make_schedule"]
