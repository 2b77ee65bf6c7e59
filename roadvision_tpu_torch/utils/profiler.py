"""Trace hooks and device timing — the port of
``roadvision_tpu/utils/profiler.py`` (SURVEY.md §5: per-stage timers +
trace hooks).

:func:`trace` is a ``torch.profiler`` capture (host and, where a card is
present, CUDA activity) that writes a Chrome trace into ``log_dir`` when
it exits, viewable in Perfetto or ``chrome://tracing``;
:data:`annotate` names a region in it. :func:`time_ms` times a callable
the way the port's profiling tools do: after a warm-up, ``iters`` calls
chained back to back between two CUDA events (the host clock with the
CPU) behind a few milliseconds of queued fills, so that the card, not
the host's enqueue, sets the pace where the card is the slower.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Iterator

import torch
from torch.profiler import ProfilerActivity, profile

annotate = torch.profiler.record_function  # with annotate("stage"): ...


@contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Capture a trace of the enclosed work into ``log_dir``
    (``trace-<time>-<pid>.json``)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(
            out / f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
                  f".json"))


# bytes written to hold the card busy ahead of a timed run (well over
# its 50 MB L2): the calls then queue behind it
BLOCKER_BYTES = 256 << 20
BLOCKER_FILLS = 40


def time_ms(fn: Callable[[], object], device: torch.device,
            iters: int = 8, warmup: int = 2) -> float:
    """Mean ms of one ``fn()`` over ``iters`` chained calls after
    ``warmup`` calls: CUDA events on a card, the host clock on the CPU.

    On a card the timed calls queue behind a few milliseconds of fills
    (``BLOCKER_FILLS`` writes of ``BLOCKER_BYTES``), so that a kernel
    shorter than its wrapper's host cost is timed at the card's pace; a
    call slower on the host than on the card is still timed at the
    host's pace, less at most the fills' time over ``iters``."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    blocker = torch.empty(BLOCKER_BYTES, dtype=torch.uint8, device=device)
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(BLOCKER_FILLS):
        blocker.fill_(i & 1)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
