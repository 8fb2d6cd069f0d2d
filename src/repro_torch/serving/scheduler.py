"""Admission scheduling and capture-size budgeting for the decode engine.

The engine rounds the live-lane count up to a small fixed menu of batch
shapes, so every decode burst runs at one of a few shapes: the menu a CUDA
graph capture will key on. Powers of two up to ``max_batch`` keep the menu
logarithmic while wasting at most half the lanes as padding.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Tuple


def capture_sizes(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch``, plus ``max_batch`` itself."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    sizes = []
    s = 1
    while s < max_batch:
        sizes.append(s)
        s *= 2
    sizes.append(max_batch)
    return tuple(sorted(set(sizes)))


def pick_capture(n: int, sizes: Tuple[int, ...]) -> int:
    """Smallest capture size >= n."""
    for s in sizes:
        if s >= n:
            return s
    raise ValueError(f"{n} live lanes exceed the largest capture size "
                     f"{sizes[-1]}")


class FifoScheduler:
    """FIFO admission queue. The engine pops a request only when both a
    decode lane and enough KV pages are available (admission backpressure);
    otherwise the request simply waits its turn."""

    def __init__(self):
        self._queue: Deque = deque()

    def submit(self, req) -> None:
        self._queue.append(req)

    def peek(self):
        return self._queue[0] if self._queue else None

    def pop(self):
        return self._queue.popleft()

    def __len__(self) -> int:
        return len(self._queue)

    def __bool__(self) -> bool:
        return bool(self._queue)
