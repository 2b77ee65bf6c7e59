"""Per-stage timers with EMA and totals, printable as a one-line summary
— a copy of ``roadvision_tpu/utils/timing.py``, grown into the port's
in-program tracing.

Every :meth:`StageTimer.stage` is also a span ``(name, start_ns, end_ns,
batch)`` kept in a bounded ring (:data:`RING_SPANS`, oldest dropped
first), in ``time.time_ns()``: the clock ``torch.profiler`` dates its
host and CUDA events on, so a span lines up with a device trace of the
same stretch. ``batch`` is the fleet batch's sequence number where the
caller gives one (the engines count their batches), so the spans of one
batch can be found together. While a profiler records, a stage is also
an :func:`~roadvision_tpu_torch.utils.profiler.annotate` range of its
name, so it shows in the profiler's trace; otherwise it opens nothing
but the two clock reads.
"""
from __future__ import annotations

import statistics
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Deque, Dict, Optional, Tuple

import torch

from .profiler import annotate

# spans kept: some 50 s of a 30 fps open loop's ~300 a second (ten a
# batch: six host spans and four device stages)
RING_SPANS = 16384

Span = Tuple[str, int, int, Optional[int]]


class StageTimer:
    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Dict[str, float] = {}
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}
        self.spans: Deque[Span] = deque(maxlen=RING_SPANS)

    @contextmanager
    def stage(self, name: str, batch: Optional[int] = None):
        named = annotate(name) if torch._C._autograd._profiler_enabled() \
            else nullcontext()
        t0 = time.time_ns()
        try:
            with named:
                yield
        finally:
            self._put(name, t0, time.time_ns(), batch)

    def add(self, name: str, seconds: float,
            batch: Optional[int] = None) -> None:
        """Record a duration measured elsewhere (a device stage from the
        step's marks) under the same totals, counts and EMA; its span in
        the ring ends when it was added."""
        t1 = time.time_ns()
        self._put(name, t1 - round(seconds * 1e9), t1, batch)

    def _put(self, name: str, t0: int, t1: int,
             batch: Optional[int]) -> None:
        dt = (t1 - t0) * 1e-9
        self.ema[name] = ((1 - self.alpha) * self.ema.get(name, dt)
                          + self.alpha * dt)
        self.total[name] = self.total.get(name, 0.0) + dt
        self.count[name] = self.count.get(name, 0) + 1
        self.spans.append((name, t0, t1, batch))

    def summary(self) -> str:
        parts = []
        for name in self.ema:
            ms = self.ema[name] * 1e3
            parts.append(f"{name}={ms:.2f}ms")
        return " ".join(parts)

    def p50_ms(self, name: str) -> float:
        """The median duration of ``name`` over the spans the ring holds,
        ms (0.0 where it holds none)."""
        durations = [t1 - t0 for n, t0, t1, _ in self.spans if n == name]
        return statistics.median(durations) * 1e-6 if durations else 0.0
