"""Learning-rate schedules (the reference's ``optim/schedule.py``): cosine
(the paper's: 2.5e-4 -> 0 over 100k steps), WSD and constant, all with a
linear warmup. Computed on the host from the integer step."""
from __future__ import annotations

import math

from ..configs.base import OptimizerConfig


def make_schedule(cfg: OptimizerConfig):
    base = cfg.lr
    warm = max(cfg.warmup_steps, 0)
    total = max(cfg.total_steps, 1)

    def sched(step: int) -> float:
        s = float(step)
        if s < warm:
            return base * min(s / max(warm, 1), 1.0)
        t = min(max((s - warm) / max(total - warm, 1), 0.0), 1.0)
        if cfg.schedule == "cosine":
            return base * (cfg.final_lr_ratio + (1 - cfg.final_lr_ratio)
                           * 0.5 * (1 + math.cos(math.pi * t)))
        if cfg.schedule == "wsd":   # warmup-stable-decay: decay in the last 10%
            decay = min(max((t - 0.9) / 0.1, 0.0), 1.0)
            return base * (1.0 - (1.0 - cfg.final_lr_ratio) * decay)
        return base

    return sched
