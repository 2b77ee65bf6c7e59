"""The port's in-program tracing on the CPU: ``utils/timing.py``'s
``StageTimer`` (a bounded ring of spans with batch numbers on the
profiler's clock, durations added from elsewhere, a true median), the
stage marks' host side (``utils/profiler.py``), and the spans that
``MultiStreamEngine`` and ``PipelineEngine`` open around a batch. The
marks themselves run only on the card (``tests/test_torch_trace_cuda.py``):
on the CPU none is launched and no device stage is recorded.
"""
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from roadvision_tpu_torch.config import DEFAULTS, merge
from roadvision_tpu_torch.io_video import SyntheticRoadSource
from roadvision_tpu_torch.runtime import MultiStreamEngine, PipelineEngine
from roadvision_tpu_torch.utils.profiler import (DEVICE_STAGES, DEVICE_STEP,
                                                 STAGE_MARKS, device_stages,
                                                 stage_mark)
from roadvision_tpu_torch.utils.timing import RING_SPANS, StageTimer

torch.set_num_threads(1)

S, B, H, W = 2, 2, 64, 96
BATCH_SPANS = ("dispatch", "stamps", "replay", "download", "device_step",
               "host_unpack")


def test_ring_is_bounded_and_keeps_order():
    timer = StageTimer()
    n = RING_SPANS + 6
    for i in range(n):
        with timer.stage(f"s{i % 3}", batch=i):
            pass
    assert len(timer.spans) == RING_SPANS
    assert [s[3] for s in timer.spans] == list(range(6, n))
    assert [s[0] for s in list(timer.spans)[:3]] == ["s0", "s1", "s2"]
    starts = [s[1] for s in timer.spans]
    assert starts == sorted(starts)
    assert all(t0 <= t1 for _, t0, t1, _ in timer.spans)
    # the totals and counts keep every stage, dropped spans included
    assert sum(timer.count.values()) == n


def test_nested_spans_share_the_batch_and_nest_in_time():
    timer = StageTimer()
    with timer.stage("outer", batch=7):
        with timer.stage("inner", batch=7):
            time.sleep(0.002)
        with timer.stage("unnumbered"):
            pass
    (n1, a1, b1, k1), (n2, _, _, k2), (n3, a3, b3, k3) = timer.spans
    assert (n1, n2, n3) == ("inner", "unnumbered", "outer")
    assert (k1, k2, k3) == (7, None, 7)
    assert a3 <= a1 <= b1 <= b3 and b1 - a1 >= 2_000_000
    assert timer.total["inner"] == pytest.approx((b1 - a1) * 1e-9)


def test_add_records_a_duration_measured_elsewhere():
    timer = StageTimer(alpha=0.5)
    timer.add("device.detector", 0.004, batch=3)
    timer.add("device.detector", 0.002, batch=4)
    assert timer.count["device.detector"] == 2
    assert timer.total["device.detector"] == pytest.approx(0.006)
    assert timer.ema["device.detector"] == pytest.approx(0.003)
    (_, a, b, k), (_, c, d, m) = timer.spans
    assert (b - a, k) == (4_000_000, 3) and (d - c, m) == (2_000_000, 4)


def test_p50_is_a_true_median():
    timer = StageTimer()
    for ms in (1, 30, 2):
        timer.add("a", ms * 1e-3)
    assert timer.p50_ms("a") == pytest.approx(2.0)
    timer.add("a", 4e-3)
    assert timer.p50_ms("a") == pytest.approx(3.0)
    assert timer.p50_ms("b") == 0.0


def test_stage_is_a_profiler_range_on_the_profilers_clock():
    """While a profiler records, a stage shows in its trace under its
    name, dated on the clock the ring's spans use."""
    timer = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("rvt_test_span", batch=1):
            time.sleep(0.005)
    hits = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "rvt_test_span"
            and e.device_type() == DeviceType.CPU]
    assert len(hits) == 1
    _, t0, t1, _ = timer.spans[0]
    e0 = hits[0].start_ns()
    e1 = e0 + hits[0].duration_ns()
    # the range opens just inside the span's clock reads
    assert t0 - 2_000_000 <= e0 and e1 <= t1 + 2_000_000
    assert e1 - e0 >= 5_000_000


def test_device_stages_add_up_to_the_step():
    stamps = np.array([1_000_000_123, 1_039_640_500, 1_063_610_777,
                       1_072_215_000], dtype=np.int64)
    got = dict(device_stages(stamps))
    assert list(got) == [*DEVICE_STAGES, DEVICE_STEP]
    assert got["device.preprocess"] == pytest.approx(0.039640377)
    assert sum(got[k] for k in DEVICE_STAGES) == pytest.approx(
        got[DEVICE_STEP], rel=1e-12)
    assert got[DEVICE_STEP] == (stamps[3] - stamps[0]) * 1e-9


def test_stage_mark_needs_a_card_buffer():
    stage_mark(None, 0)             # the CPU: no buffer, no mark
    with pytest.raises(ValueError, match="int64 CUDA tensor"):
        stage_mark(torch.zeros(STAGE_MARKS, dtype=torch.int64), 0)


def _cfg():
    return merge(DEFAULTS, {
        "preprocess": {"enabled": True, "chain": [
            {"name": "CLAHEDehaze",
             "params": {"space": "YCrCb", "clip_limit": 2.0,
                        "tile_grid": 4}}]},
        "detect": {"enabled": True, "model": "assets/yolov8n_synthetic_256.npz",
                   "device": "cpu", "max_det": 8, "imgsz": 96,
                   "classes_keep": [], "conf_thres": 0.02,
                   "compute_dtype": "float32"},
        "tracking": {"enabled": True},
        "tpu": {"batch_size": B, "track_slots": 8,
                "compute_dtype": "float32"}})


def _frames(k, s):
    return np.stack([np.stack([
        SyntheticRoadSource(W, H, num_vehicles=6, seed=i).render(k * B + j)
        for j in range(B)]) for i in range(s)])


def _batch_spans(timer, batches):
    got = {}
    for name, t0, t1, k in timer.spans:
        assert t0 <= t1
        got.setdefault(k, []).append(name)
    assert sorted(got) == list(range(batches))
    for names in got.values():
        assert sorted(names) == sorted(BATCH_SPANS)
    return got


def test_fleet_batches_open_their_spans_once_each():
    """``MultiStreamEngine.dispatch_batch`` / ``collect_batch`` on the
    CPU: each batch opens ``dispatch`` (holding ``stamps``, ``replay``
    and ``download``), ``device_step`` and ``host_unpack`` once, all with
    its sequence number; no mark, no device stage."""
    eng = MultiStreamEngine(_cfg(), S, devices=["cpu"])
    assert eng.engine.stage_stamps is None
    pending = []
    for k in range(3):
        ts = 100.0 + (k * B + np.arange(B))[None].repeat(S, 0) / 30.0
        pending.append(eng.dispatch_batch(_frames(k, S), ts))
        if len(pending) == 2:
            eng.collect_batch(pending.pop(0))
    eng.collect_batch(pending.pop(0))
    _batch_spans(eng.timer, 3)
    spans = {(n, k): (a, b) for n, a, b, k in eng.timer.spans}
    for k in range(3):
        d0, d1 = spans[("dispatch", k)]
        for part in ("stamps", "replay", "download"):
            a, b = spans[(part, k)]
            assert d0 <= a <= b <= d1
        assert d1 <= spans[("device_step", k)][0]
    assert not [n for n in eng.timer.count if n.startswith("device.")]
    assert eng.timer.count["device_step"] == 3


def test_single_stream_batches_open_the_same_spans():
    eng = PipelineEngine(_cfg(), device="cpu")
    assert eng.stage_stamps is None
    for k in range(2):
        eng.process_batch(_frames(k, 1)[0],
                          100.0 + (k * B + np.arange(B)) / 30.0,
                          want_proc=False)
    _batch_spans(eng.timer, 2)
    assert not [n for n in eng.timer.count if n.startswith("device.")]
