"""What the per-layer metrics that read the program's own tracing read:
the fleet engine's ``StageTimer`` (``roadvision_tpu_torch/utils/
timing.py``). Its totals hold the device stages that the fleet step
marks on the card (``device.preprocess``, ``device.detector``,
``device.tracker``, ``device.step``: ``csrc/trace.cu``'s four marks, read
back with each batch's results) and the host spans the engine opens in
``dispatch_batch`` (``dispatch``, and inside it ``stamps``, ``replay``,
``download``); its ring holds those spans with their times, on the
profiler's clock. Each reader returns None where it finds nothing to
read: on the CPU, or in a program whose timer records no such stage or
span. The names are written out here, not imported, for that reason.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

# the device stages between consecutive marks, the kernels that mark them
STAGES = ("preprocess", "detector", "tracker")
MARK_KERNEL = "rvt_stage_mark_kernel<{}>"
# the engine's dispatch span and the spans inside it
DISPATCH = "dispatch"
DISPATCH_PARTS = ("stamps", "upload", "replay", "download")


def _per_batch_ms(run, name: str) -> Optional[float]:
    """A timer entry's total over the window's untraced part ÷ its count,
    ms."""
    total, count = run.timer.get(name, (0.0, 0))
    return total / count * 1e3 if count else None


def mark_intervals(profile) -> Dict[str, List[float]]:
    """Each stage's seconds in the traced stretch between the starts of
    the mark kernels that bound it, over every step whose four marks the
    stretch holds in order."""
    marks = sorted((a, k) for n, a, _ in profile.kernels
                   for k in range(len(STAGES) + 1)
                   if MARK_KERNEL.format(k) in n)
    out: Dict[str, List[float]] = {s: [] for s in STAGES}
    step: List[float] = []
    for t, k in marks:
        step = step + [t] if k == len(step) else ([t] if k == 0 else [])
        if len(step) == len(STAGES) + 1:
            for s, a, b in zip(STAGES, step, step[1:]):
                out[s].append(b - a)
            step = []
    return out


def _spans(run) -> list:
    """The spans the engine's timer holds, (name, start ns, end ns,
    batch); none where its timer keeps no ring."""
    return list(getattr(run.engine.timer, "spans", None) or ())


def _traced_batches(run) -> set:
    """The sequence numbers of the batches whose ``dispatch`` span begins
    in the traced stretch."""
    lo, hi = run.profile.stretch
    return {k for n, t0, _, k in _spans(run)
            if n == DISPATCH and lo <= t0 * 1e-9 < hi}


def _step_stage_ms(run, stage: str) -> Optional[float]:
    """Device ms a batch of ``stage`` inside the step as it ran, over the
    window's untraced part; beside it, on standard error, the marks of
    the traced batches and the same stage between the mark kernels of
    the traced stretch."""
    name = f"device.{stage}"
    value = _per_batch_ms(run, name)
    if value is not None and run.profile is not None:
        seen = mark_intervals(run.profile)[stage]
        batches = _traced_batches(run)
        marked = [(t1 - t0) * 1e-6 for n, t0, t1, k in _spans(run)
                  if n == name and k in batches]
        k = STAGES.index(stage)
        print(f"[program] {name}: {value:.4f} ms a batch from the marks, "
              f"untraced part; traced batches "
              + (f"{sum(marked) / len(marked):.4f} ms over {len(marked)}"
                 if marked else "none")
              + f"; in the trace between {MARK_KERNEL.format(k)} and "
              f"{MARK_KERNEL.format(k + 1)} "
              + (f"{sum(seen) / len(seen) * 1e3:.4f} ms over {len(seen)} "
                 f"steps" if seen else "no marks"), file=sys.stderr)
    return value


def step_preprocess_ms(run) -> Optional[float]:
    """Preprocess's device time inside the fleet step (marks 0 → 1)."""
    return _step_stage_ms(run, "preprocess")


def step_detector_ms(run) -> Optional[float]:
    """The detector's whole pass, NMS or top-k included (marks 1 → 2)."""
    return _step_stage_ms(run, "detector")


def step_tracker_ms(run) -> Optional[float]:
    """The tracker tail with GMC and geometry, on the live tracks of the
    running cameras (marks 2 → 3)."""
    return _step_stage_ms(run, "tracker")


def stamps_upload_ms(run) -> Optional[float]:
    """Host ms a batch of the engine's ``stamps`` span: the stamps'
    rebase and their copy to the card."""
    return _per_batch_ms(run, "stamps")


def _ring(run) -> List[Tuple[str, float, float]]:
    """The dispatch spans and those inside them that the engine's timer
    holds, (name, start s, end s)."""
    names = {DISPATCH, *DISPATCH_PARTS}
    return [(n, t0 * 1e-9, t1 * 1e-9) for n, t0, t1, _ in _spans(run)
            if n in names]


def dispatch_idle(run) -> Optional[Tuple[Dict[str, float], int]]:
    """The device's idle gaps in the traced stretch that begin inside one
    of the program's ``dispatch`` spans, each counted whole (as
    ``trace.Profile.idle_gaps`` counts them), summed by the innermost
    span open at the gap's start (``dispatch`` itself where none of
    :data:`DISPATCH_PARTS` is) → (seconds by span, dispatch spans that
    begin in the stretch). The stretch's head, before its first kernel,
    is no gap: the card is still running the batch queued before the
    profiler opened, whose kernels the profiler does not record."""
    prof = run.profile
    if prof is None or not prof.kernels:
        return None
    lo, hi = prof.stretch
    spans = _ring(run)
    outer = [(a, b) for n, a, b in spans
             if n == DISPATCH and b > lo and a < hi]
    batches = sum(1 for a, _ in outer if lo <= a < hi)
    if not batches:
        return None
    inner = [s for s in spans if s[0] != DISPATCH]
    busy = prof.busy()
    edges = [busy[0][0]] + [x for iv in busy for x in iv] + [hi]
    split: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a or not any(s0 <= a < s1 for s0, s1 in outer):
            continue
        label = next((n for n, s0, s1 in inner if s0 <= a < s1), DISPATCH)
        split[label] = split.get(label, 0.0) + (b - a)
    return split, batches


def dispatch_idle_ms(run) -> Optional[float]:
    """Device idle ms a fleet batch under the program's ``dispatch``
    spans in the traced stretch; the split by span on standard error."""
    found = dispatch_idle(run)
    if found is None:
        return None
    split, batches = found
    total = sum(split.values())
    prof = run.profile
    head = prof.busy()[0][0] - prof.stretch[0]
    rate = run.batches_per_s_untraced
    print(f"[program] idle under dispatch: {total * 1e3:.3f} ms over "
          f"{batches} batches (the stretch's unrecorded head, "
          f"{head * 1e3:.3f} ms, left out); by span "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                      sorted(split.items(), key=lambda kv: -kv[1]))
          + f"; batches a second: traced {batches / prof.window_s:.3f}, "
          f"untraced " + (f"{rate:.3f}" if rate else "-"), file=sys.stderr)
    return total / batches * 1e3
