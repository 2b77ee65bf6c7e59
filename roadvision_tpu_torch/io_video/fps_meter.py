"""Exponentially-smoothed FPS estimation — a copy of
``roadvision_tpu/io_video/fps_meter.py``.

Semantics preserved exactly: the first tick only arms the meter and returns
0.0; afterwards ``fps ← (1−α)·fps + α·(1/dt)`` with dt floored at 1 µs.
Adds a monotonically increasing frame counter for observability.
"""
from __future__ import annotations

import time
from typing import Optional


class FPSMeter:
    __slots__ = ("alpha", "fps", "frames", "_prev")

    def __init__(self, alpha: float = 0.1):
        self.alpha = float(alpha)
        self.fps = 0.0
        self.frames = 0
        self._prev: Optional[float] = None

    def reset(self) -> None:
        self.fps = 0.0
        self.frames = 0
        self._prev = None

    def tick(self, now: Optional[float] = None) -> float:
        now = now or time.time()
        self.frames += 1
        prev, self._prev = self._prev, now
        if prev is None:
            return self.fps
        instantaneous = 1.0 / max(1e-6, now - prev)
        self.fps += self.alpha * (instantaneous - self.fps)
        return self.fps
