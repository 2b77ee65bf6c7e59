"""One run of one cell: set-up, the measured window, the traced
stretch, the per-layer readers and the judgement.

The program under test is ``roadvision_tpu_torch``'s camera fleet,
``runtime/multi_engine.py::MultiStreamEngine``, driven through
``dispatch_batch`` / ``collect_batch`` with device-resident frames
(``Upload``\\ s of the benchmark's camera pool), one replayed CUDA graph
a fleet batch where the engine's ``step_mode`` is ``"graph"``.

Two loops, as the traffic mix says:

* ``closed``: ``in_flight`` fleet batches in flight, the next dispatched
  as soon as one has been collected; ``fleet_fps`` counts the frames
  whose results reached the host inside the window.
* ``open``: fleet batch n is due at n / fps after the window opens and
  is dispatched then (or as soon as the generator can: its lateness is
  recorded), whether or not earlier ones have come back; a batch's
  latency is the time its results reached the host less its due time.
  ``frame_latency_p95_ms`` is the 95th percentile over every batch due
  in the window, those that come back after it included.
"""
from __future__ import annotations

import gc
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from . import frames
from .spec import ROOT, Cell, engine_config

WARMUP_BATCHES = 2
LATE_WAIT_S = 60.0        # how long the judge waits for a batch past close
POLL_S = 0.0002           # the open loop's sleep while nothing is due


@dataclass
class Window:
    """What the window saw: each dispatched batch's stamps, due and
    dispatch times, results and the time they came."""
    t0: float
    seconds: float
    stamps: List[np.ndarray] = field(default_factory=list)
    due: List[float] = field(default_factory=list)
    sent: List[float] = field(default_factory=list)
    done: List[Optional[float]] = field(default_factory=list)
    results: List[Any] = field(default_factory=list)


@dataclass
class Run:
    """What a per-layer reader may read: the cell, the program's engine
    and the camera pool (alive), the window, the engine's stage timer
    over the window's untraced part, the traced stretch, when it
    opened, and the fleet batches a second before it."""
    cell: Cell
    engine: Any
    pool: torch.Tensor
    device: torch.device
    window: Window
    timer: Dict[str, tuple]
    root: Path = ROOT
    profile: Any = None
    traced_from: float = float("inf")     # when the profiler opened
    batches_per_s_untraced: Optional[float] = None

    def fleet_batch(self, k: int = 0):
        """The pool's fleet batch starting at clip frame ``k``:
        (frames (S, B, H, W, 3), stamps (S, B) on the device)."""
        b = self.cell.batch
        x = self.pool[:, k:k + b]
        ts = torch.arange(k, k + b, dtype=torch.float32, device=self.device) \
            / float(self.cell.traffic["fps"])
        return x, ts.expand(self.cell.streams, b).contiguous()


def stamps(cell: Cell, n: int) -> np.ndarray:
    """Fleet batch n's stamps (S, B): frame i = n·B + j of every camera at
    i / fps, plus ``cut_s`` for each loop of the clip before it (a camera
    cut: the scene jumps back, so the stamps jump on)."""
    t, b = cell.traffic, cell.batch
    i = n * b + np.arange(b, dtype=np.int64)
    ts = i / float(t["fps"]) + (i // int(t["clip_frames"])) * float(t["cut_s"])
    return ts[None].repeat(cell.streams, 0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Fleet:
    """The engine and the pool, and the loop's calls into them."""

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 overrides: Optional[Dict[str, Any]] = None):
        from roadvision_tpu_torch.config import DEFAULTS, merge
        from roadvision_tpu_torch.runtime.engine import Upload
        from roadvision_tpu_torch.runtime.multi_engine import \
            MultiStreamEngine
        self.cell, self.device = cell, device
        t = cell.traffic
        self.clip = int(t["clip_frames"])
        if self.clip % cell.batch:
            raise ValueError("the clip must hold whole fleet batches")
        t0 = time.perf_counter()
        self.pool = frames.camera_pool(seed, cell.streams, self.clip,
                                       int(t["height"]), int(t["width"]),
                                       int(t["vehicles"]), device)
        _sync(device)
        t1 = time.perf_counter()
        cfg = merge(DEFAULTS, engine_config(cell))
        if overrides:
            cfg = merge(cfg, overrides)
        self.engine = MultiStreamEngine(cfg, cell.streams, devices=[device])
        _sync(device)
        self.setup_times = {"clips": t1 - t0,
                            "engine": time.perf_counter() - t1}
        self.upload = Upload
        self.fps = float(t["fps"])
        cut = float(t["cut_s"])
        stale = float(cell.config["pipeline"]["tracking"]["max_staleness"])
        if cut <= stale:
            raise ValueError(f"cut_s {cut} must exceed the trackers' "
                             f"staleness {stale}: the last loop's tracks "
                             f"would live on into the next")

    def dispatch(self, n: int, win: Window):
        """Queue fleet batch n: every camera's clip frames from n·B (modulo
        the clip), stamped by :func:`stamps`."""
        b = self.cell.batch
        k = (n * b) % self.clip
        x = self.pool[:, k:k + b]
        ts = stamps(self.cell, n)
        with record_function("roadbench.dispatch"):
            h = self.engine.dispatch_batch(
                x, ts, device_frames=[self.upload(x, None, None)])
        win.stamps.append(ts)
        return h

    def collect(self, handle):
        with record_function("roadbench.collect"):
            return self.engine.collect_batch(handle)

    @staticmethod
    def ready(handle) -> bool:
        return all(done is None or done.query() for _, _, done in handle[2])

    def warm_up(self) -> None:
        """The cell's one fleet shape, captured and replayed; then fresh
        tracks and time origin for the window."""
        scratch = Window(0.0, 0.0)
        for n in range(WARMUP_BATCHES):
            self.collect(self.dispatch(n, scratch))
        self.engine.reset()
        _sync(self.device)


def no_gc(loop):
    """Run a loop with the cyclic garbage collector off: the window keeps
    every result to judge it afterwards, and a full collection over
    them stalls the loop for ~0.1 s now and then, which a deployment
    that drops its results does not see."""
    def run(*args, **kwargs):
        gc.collect()
        gc.disable()
        try:
            return loop(*args, **kwargs)
        finally:
            gc.enable()
    run.__doc__ = loop.__doc__
    return run


@no_gc
def closed_loop(fleet: Fleet, seconds: float, in_flight: int,
                on_tick=None) -> Window:
    win = Window(time.perf_counter(), seconds)
    end = win.t0 + seconds
    pending: deque = deque()
    n = 0
    while True:
        now = time.perf_counter()
        if on_tick is not None:
            on_tick(now - win.t0)
        if now >= end:
            break
        if len(pending) < in_flight:
            win.due.append(now)
            win.sent.append(now)
            pending.append((n, fleet.dispatch(n, win)))
            win.done.append(None)
            win.results.append(None)
            n += 1
            continue
        i, h = pending.popleft()
        win.results[i] = fleet.collect(h)
        win.done[i] = time.perf_counter()
    while pending:
        i, h = pending.popleft()
        win.results[i] = fleet.collect(h)
        win.done[i] = time.perf_counter()
    return win


@no_gc
def open_loop(fleet: Fleet, seconds: float, max_in_flight: int,
              on_tick=None) -> Window:
    win = Window(time.perf_counter(), seconds)
    period = 1.0 / fleet.fps
    due_total = int(np.ceil(seconds / period))
    pending: deque = deque()
    n = 0
    while n < due_total or pending:
        now = time.perf_counter()
        if on_tick is not None:
            on_tick(now - win.t0)
        due = win.t0 + n * period
        if n < due_total and now >= due and len(pending) < max_in_flight:
            win.due.append(due)
            win.sent.append(now)
            pending.append((n, fleet.dispatch(n, win)))
            win.done.append(None)
            win.results.append(None)
            n += 1
            continue
        if pending and (fleet.ready(pending[0][1]) or n >= due_total):
            if now > win.t0 + seconds + LATE_WAIT_S:
                break
            i, h = pending.popleft()
            win.results[i] = fleet.collect(h)
            win.done[i] = time.perf_counter()
            continue
        with record_function("roadbench.idle"):
            time.sleep(min(POLL_S, max(0.0, due - now)))
    return win


def end_to_end(cell: Cell, win: Window) -> Dict[str, float]:
    """The window's end-to-end readings, by the traffic's loop."""
    b = cell.streams * cell.batch
    end = win.t0 + win.seconds
    if cell.traffic["loop"] == "closed":
        done = sum(1 for t in win.done if t is not None and t <= end)
        return {"fleet_fps": done * b / win.seconds}
    lat = [t - d for t, d in zip(win.done, win.due) if t is not None]
    return {"frame_latency_p95_ms": float(np.percentile(lat, 95)) * 1e3}
