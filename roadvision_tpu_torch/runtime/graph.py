"""A device step captured in a CUDA graph and replayed — the port's
counterpart of ``jax.jit`` around ``PipelineEngine.build_raw_step`` (the
JAX engine's ``_step_for``, ``roadvision_tpu/runtime/engine.py:548``):
one graph per (shape, want_proc), launched with one call a batch.

:class:`CapturedStep` takes a pure ``fn(state, *args) → (outputs,
state')`` whose state is a tuple of tensors (a ``SortState``, stacked or
not, its fields followed by GMC's thumbnails and flag where GMC is on)
or None. It owns static buffers for ``args``; the caller's state
tensors are the graph's state buffers, which the graph itself
overwrites with ``state'`` at the end of each replay. Whoever resets or
restores the state copies into those tensors and never rebinds them. The
outputs are static tensors too, overwritten by the next replay, so a
caller consumes them (or queues a copy) first.

Capture follows PyTorch's documentation: a warm-up on a side stream
(which builds the kernels, uploads the tables and constants, creates
the library handles and lets cuDNN choose its algorithms), then
``torch.cuda.graph``. Nothing is caught: a step that reads the host, or
uploads from pageable memory, fails the capture, and that raises. The
capture's error mode is thread-local, so that the engine's reader thread
may go on uploading frames on its own stream meanwhile.

The kernels' launch counts (``kernels.launch_counts``) and the
tracker's host reads (``track/sort.py::host_syncs``) are Python
counters, which move while the step is captured and not while it is
replayed. The warm-up's calls are real runs and keep what they add
(WARMUP_CALLS steps' worth at each capture); :class:`CapturedStep` takes
back what the capture itself added, which launched nothing, and adds the
captured counts on every replay, so that a replay counts as the same
step run eagerly.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..kernels import _build
from ..track import sort as _sort

WARMUP_CALLS = 2


def _counters() -> Dict[str, int]:
    return {**_build.launch_counts, "host_syncs": _sort.host_syncs}


def _set_counters(values: Dict[str, int]) -> None:
    for k in _build.launch_counts:
        _build.launch_counts[k] = values[k]
    _sort.host_syncs = values["host_syncs"]


class CapturedStep:
    """``fn(state, *args) → (outputs, state')`` captured once on ``args``'
    shapes (the first call's values warm it up) and replayed by calling
    the object with new ``args``: → the static outputs (a nested tuple of
    tensors and None, as ``fn`` returns them), ``state`` (kept as
    ``self.state``) updated in place."""

    def __init__(self, fn: Callable, state: Optional[Sequence[torch.Tensor]],
                 args: Sequence[torch.Tensor]):
        self.device = args[0].device
        if self.device.type != "cuda":
            raise ValueError("a CUDA graph needs its inputs on the card")
        self.state = state
        with torch.inference_mode(), torch.cuda.device(self.device):
            self.args = tuple(a.clone() for a in args)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    fn(state, *self.args)
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            start = _counters()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  stream=torch.cuda.Stream(self.device),
                                  capture_error_mode="thread_local"):
                outputs, new_state = fn(state, *self.args)
                if state is not None:
                    for dst, src in zip(state, new_state):
                        if src is not dst:
                            dst.copy_(src)
            end = _counters()
        self.outputs = outputs
        # what one replay launches and reads
        self.counts = {k: end[k] - start[k] for k in end}
        _set_counters(start)

    def __call__(self, *args: torch.Tensor):
        with torch.inference_mode(), torch.cuda.device(self.device):
            for dst, src in zip(self.args, args):
                if src is not dst:
                    dst.copy_(src, non_blocking=True)
            self.graph.replay()
        now = _counters()
        _set_counters({k: now[k] + self.counts[k] for k in now})
        return self.outputs
