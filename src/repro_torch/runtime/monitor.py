"""Straggler monitoring (the reference's ``runtime/monitor.py``).

``StragglerMonitor`` keeps an exponential moving average of the step's wall
time and flags a step that takes more than ``threshold`` times it (a slow
host, a throttled card). ``on_straggler(step, dt, mean)`` is the hook for
an orchestrator; the trainer logs and counts.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, ewma: float = 0.9,
                 warmup_steps: int = 5,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.threshold = threshold
        self.ewma_coef = ewma
        self.warmup = warmup_steps
        self.on_straggler = on_straggler
        self.mean: Optional[float] = None
        self.count = 0
        self.flagged: List[int] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        """End the step begun by ``start``; returns its wall time in s. A
        flagged step does not enter the mean."""
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.mean is None:
            self.mean = dt
        if self.count > self.warmup and dt > self.threshold * self.mean:
            self.flagged.append(step)
            if self.on_straggler:
                self.on_straggler(step, dt, self.mean)
        else:
            self.mean = self.ewma_coef * self.mean + (1 - self.ewma_coef) * dt
        return dt
