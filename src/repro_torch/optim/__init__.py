"""The reference's optimizer pieces: AdamW with float32 master weights,
global-norm clipping and learning-rate schedules."""
from .adamw import OptState, adamw_init, adamw_update
from .clip import clip_by_global_norm, global_norm
from .schedule import make_schedule

__all__ = ["OptState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "make_schedule"]
