"""The device trace of a stretch of the window: ``torch.profiler`` with
CUDA activity, read into kernel intervals and the benchmark's own host
spans, all on one clock. No trace file is written."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# the benchmark's host spans inside the window, by what the host does:
# queueing a fleet batch, waiting for its results and unpacking them,
# sleeping until the next batch is due (open loop)
SPANS = ("roadbench.dispatch", "roadbench.collect", "roadbench.idle")


class Profile:
    """Kernels (name, start, end) in seconds, the stretch's (start, end)
    and the host spans (name, start, end) inside it."""

    def __init__(self, kernels: List[Tuple[str, float, float]],
                 stretch: Tuple[float, float],
                 spans: List[Tuple[str, float, float]]):
        self.stretch = stretch
        lo, hi = stretch
        self.kernels = [(n, max(a, lo), min(b, hi)) for n, a, b in kernels
                        if b > lo and a < hi]
        self.spans = spans

    @property
    def window_s(self) -> float:
        return self.stretch[1] - self.stretch[0]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the kernels' intervals, in time order."""
        out: List[Tuple[float, float]] = []
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def kernel_time(self, name: str) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds ``name``."""
        hits = [b - a for n, a, b in self.kernels if name in n]
        return len(hits), sum(hits)

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, float] = {}
        for name, a, b in self.kernels:
            total[name] = total.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Device idle time between the busy intervals, summed by the
        host span that was open when each gap began."""
        lo, hi = self.stretch
        edges = [lo] + [x for iv in self.busy() for x in iv] + [hi]
        total: Dict[str, float] = {}
        spans = sorted(self.spans, key=lambda s: s[1])
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            label = "host: other"
            for name, s0, s1 in spans:
                if s0 <= a < s1:
                    label = "host: " + name.split(".", 1)[1]
            total[label] = total.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]


@contextmanager
def traced() -> Iterator[List[Optional[Profile]]]:
    """Profile the enclosed stretch; the yielded list holds its
    :class:`Profile` once the block has ended."""
    box: List[Optional[Profile]] = [None]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    try:
        yield box
        torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    events = [(e.name(), e.device_type() == DeviceType.CUDA,
               e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
              for e in prof.profiler.kineto_results.events()]
    # the profiler projects each host annotation onto the device's
    # timeline under the same name: device work is what has no host
    # event of its name (kernels, copies, fills)
    host_names = {n for n, on_dev, _, _ in events if not on_dev}
    kernels = [(n, a, b) for n, on_dev, a, b in events
               if on_dev and n not in host_names]
    spans = [(n, a, b) for n, on_dev, a, b in events
             if not on_dev and n in SPANS]
    # the stretch: from the first of the loop's spans to the last (the
    # loop runs them back to back while the profiler is open)
    if spans:
        box[0] = Profile(kernels, (min(a for _, a, _ in spans),
                                   max(b for _, _, b in spans)), spans)
