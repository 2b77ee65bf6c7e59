"""Per-stage timers with EMA and totals, printable as a one-line summary
— a copy of ``roadvision_tpu/utils/timing.py``.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class StageTimer:
    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Dict[str, float] = {}
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.ema[name] = ((1 - self.alpha) * self.ema.get(name, dt)
                              + self.alpha * dt)
            self.total[name] = self.total.get(name, 0.0) + dt
            self.count[name] = self.count.get(name, 0) + 1

    def summary(self) -> str:
        parts = []
        for name in self.ema:
            ms = self.ema[name] * 1e3
            parts.append(f"{name}={ms:.2f}ms")
        return " ".join(parts)

    def p50_ms(self, name: str) -> float:
        if self.count.get(name, 0) == 0:
            return 0.0
        return self.total[name] / self.count[name] * 1e3
