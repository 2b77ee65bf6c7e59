"""The readers of the program's own tracing (``roadbench/program.py``) on
hand-made runs: a timer dict as ``run.py`` builds it, a ``Profile`` of
known kernels and an engine whose timer holds a ring of known spans.
Each returns the number the record gives, and None without one (the
CPU, or a program that records no such stage or span)."""
from types import SimpleNamespace

import pytest
import torch

from roadbench import program
from roadbench.harness import Run
from roadbench.trace import Profile


def _mark(k):
    return f"void rvt_stage_mark_kernel<{k}>(long long*)"


def _run(timer=None, profile=None, spans=None):
    engine = SimpleNamespace(timer=SimpleNamespace(spans=spans) if spans
                             is not None else SimpleNamespace())
    return Run(cell=None, engine=engine, pool=None,
               device=torch.device("cpu"), window=None, timer=timer or {},
               profile=profile)


def _ns(s):
    return round(s * 1e9)


def test_device_stages_and_stamps_read_total_over_count():
    run = _run({"device.preprocess": (0.0792, 2),
                "device.detector": (0.048, 2),
                "device.tracker": (0.0165, 2), "stamps": (0.0003, 3)})
    assert program.step_preprocess_ms(run) == pytest.approx(39.6)
    assert program.step_detector_ms(run) == pytest.approx(24.0)
    assert program.step_tracker_ms(run) == pytest.approx(8.25)
    assert program.stamps_upload_ms(run) == pytest.approx(0.1)
    empty = _run({"host_unpack": (0.01, 1)})
    for read in (program.step_preprocess_ms, program.step_detector_ms,
                 program.step_tracker_ms, program.stamps_upload_ms):
        assert read(empty) is None


def test_mark_intervals_take_whole_steps_only():
    kernels = [(_mark(0), 0.000, 0.0001), ("gemm", 0.001, 0.009),
               (_mark(1), 0.010, 0.0101), (_mark(2), 0.015, 0.0151),
               (_mark(3), 0.018, 0.0181),
               # a step whose mark 0 came before the stretch
               (_mark(2), 0.035, 0.0351), (_mark(3), 0.038, 0.0381),
               (_mark(0), 0.040, 0.0401), (_mark(1), 0.052, 0.0521),
               (_mark(2), 0.056, 0.0561), (_mark(3), 0.060, 0.0601),
               (_mark(0), 0.070, 0.0701), (_mark(1), 0.080, 0.0801)]
    prof = Profile(kernels, (0.0, 0.09), [])
    got = program.mark_intervals(prof)
    assert got["preprocess"] == pytest.approx([0.010, 0.012])
    assert got["detector"] == pytest.approx([0.005, 0.004])
    assert got["tracker"] == pytest.approx([0.003, 0.004])
    # the stage readers read the timer, with the trace beside it
    run = _run({"device.tracker": (0.007, 2)}, prof)
    assert program.step_tracker_ms(run) == pytest.approx(3.5)


def test_dispatch_idle_counts_gaps_that_begin_under_dispatch():
    """Busy 0–1, 1.5–2, 2.2–3 s of a 0–3 s stretch: the gap at 1.0 s
    begins inside batch 1's dispatch (in its replay) and counts whole,
    the gap at 2.0 s begins outside any dispatch and does not; batch 0's
    dispatch lies before the stretch, batch 2's inside it. Two batches
    in the stretch: 0.25 s a batch."""
    prof = Profile([("k", 0.0, 1.0), ("k", 1.5, 2.0), ("k", 2.2, 3.0)],
                   (0.0, 3.0), [])
    spans = [("dispatch", _ns(-1.0), _ns(-0.5), 0),
             ("host_unpack", _ns(-0.4), _ns(-0.3), 0),
             ("replay", _ns(0.95), _ns(1.2), 1),
             ("stamps", _ns(0.9), _ns(0.95), 1),
             ("dispatch", _ns(0.9), _ns(1.3), 1),
             ("host_unpack", _ns(1.9), _ns(2.1), 0),
             ("dispatch", _ns(2.5), _ns(2.8), 2)]
    run = _run(profile=prof, spans=spans)
    split, batches = program.dispatch_idle(run)
    assert batches == 2 and split == {"replay": pytest.approx(0.5)}
    assert program.dispatch_idle_ms(run) == pytest.approx(250.0)
    # a gap under dispatch but none of its parts is dispatch's own
    spans[2] = ("replay", _ns(1.1), _ns(1.2), 1)
    assert program.dispatch_idle(run)[0] == {"dispatch": pytest.approx(0.5)}


def test_the_stretchs_unrecorded_head_is_no_gap():
    """The stretch opens under a dispatch while the card still runs the
    batch queued before the profiler: its first kernel comes 0.4 s in.
    That head is not idle; the gap at 1.0 s is."""
    prof = Profile([("k", 0.4, 1.0), ("k", 1.5, 2.0)], (0.0, 2.0), [])
    spans = [("dispatch", _ns(-0.01), _ns(0.1), 4),
             ("dispatch", _ns(0.9), _ns(1.2), 5)]
    run = _run(profile=prof, spans=spans)
    assert program.dispatch_idle(run) == ({"dispatch": pytest.approx(0.5)},
                                          1)
    assert program.dispatch_idle_ms(run) == pytest.approx(500.0)


@pytest.mark.parametrize("case", ["no profile", "no ring", "empty ring",
                                  "no kernels"])
def test_dispatch_idle_without_a_record_is_none(case):
    prof = Profile([("k", 0.0, 1.0), ("k", 1.5, 2.0)], (0.0, 2.0), [])
    spans = [("dispatch", _ns(0.9), _ns(1.3), 0)]
    run = {"no profile": _run(spans=spans),
           "no ring": _run(profile=prof),
           "empty ring": _run(profile=prof, spans=[]),
           "no kernels": _run(profile=Profile([], (0.0, 2.0), []),
                              spans=spans)}[case]
    assert program.dispatch_idle_ms(run) is None
