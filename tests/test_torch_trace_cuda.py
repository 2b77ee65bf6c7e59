"""The step's stage marks and the engine's spans on the card.

Marked ``cuda``; each test skips where no CUDA device is present. Run on
a machine with an NVIDIA card (``RVT_TEST_PLATFORM=card`` keeps
``tests/conftest.py`` from importing JAX):

    RVT_TEST_PLATFORM=card python -m pytest tests/test_torch_trace_cuda.py -m cuda -q

* A replayed fleet step writes four increasing stamps; its three device
  stages add up to ``device.step`` to the nanosecond.
* Each stage's time from the marks is within 10 % of the interval
  between the same two ``rvt_stage_mark_kernel<k>`` launches in a
  ``torch.profiler`` trace of the same replays.
* A ``StageTimer`` span around ``torch.cuda._sleep`` and a synchronize
  holds that kernel's interval in a trace within 50 µs: the ring's spans
  and the profiler's device events share one clock.
* The marks change no output: the fleet replayed with marks equals the
  same fleet replayed without them and the fleet run eagerly, as the
  graph-against-eager tests require (detections equal).
"""
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from roadvision_tpu_torch.config import DEFAULTS, merge
from roadvision_tpu_torch.io_video import SyntheticRoadSource
from roadvision_tpu_torch.runtime import MultiStreamEngine, PipelineEngine
from roadvision_tpu_torch.utils.profiler import DEVICE_STAGES, DEVICE_STEP
from roadvision_tpu_torch.utils.timing import StageTimer

pytestmark = pytest.mark.cuda

STAGE_TOL = 0.10          # marks' stage time against the trace's
CLOCK_TOL_NS = 50_000     # span against the kernel it waited for


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the marks run only on the card)")
    return torch.device("cuda")


def _cfg(h, w, batch, imgsz, dtype="float32"):
    return merge(DEFAULTS, {
        "preprocess": {"enabled": True, "chain": [
            {"name": "CLAHEDehaze", "params": {}},
            {"name": "MedianDerain", "params": {"ksize": 3}}]},
        "detect": {"enabled": True,
                   "model": "assets/yolov8n_synthetic_256.npz",
                   "imgsz": imgsz, "max_det": 20, "classes_keep": [2],
                   "compute_dtype": dtype},
        "tracking": {"enabled": True, "max_staleness": 1.2,
                     "iou_threshold": 0.35, "speed_window": 0.8},
        "geometry": {"enabled": True, "projector": {
            "type": "homography",
            "image_points": [[0, h], [w, h], [0, 0.4 * h], [w, 0.4 * h]],
            "world_points": [[0, 0], [20, 0], [0, 120], [20, 120]],
            "origin": [10.0, 0.0], "max_distance": 1000.0}},
        "tpu": {"batch_size": batch, "compute_dtype": dtype}})


def _fleet(n, s, b, h, w):
    """n fleet batches (S, B, H, W, 3) of S cameras, each panning."""
    srcs = [SyntheticRoadSource(w, h, num_vehicles=6, seed=i)
            for i in range(s)]
    return [(np.stack([np.stack([np.roll(src.render(b * k + i),
                                         3 * (b * k + i), axis=1)
                                 for i in range(b)]) for src in srcs]),
             1000.0 + np.tile((b * k + np.arange(b)) / 30.0, (s, 1)))
            for k in range(n)]


def _durations(timer, batches):
    """{(stage, batch): ns} of the device stages the timer holds."""
    return {(n, k): t1 - t0 for n, t0, t1, k in timer.spans
            if n.startswith("device.") and k in batches}


def _mark_intervals(prof):
    """Per stage, the ns between the starts of consecutive mark kernels,
    over the traced steps."""
    marks = sorted((e.start_ns(), k) for e in prof.profiler.kineto_results
                   .events() if e.device_type() == DeviceType.CUDA
                   for k in range(4) if f"rvt_stage_mark_kernel<{k}>"
                   in e.name())
    out = {s: [] for s in DEVICE_STAGES}
    step = []
    for t, k in marks:
        step = step + [t] if k == len(step) else ([t] if k == 0 else [])
        if len(step) == 4:
            for s, a, b in zip(DEVICE_STAGES, step, step[1:]):
                out[s].append(b - a)
            step = []
    return out


def test_replayed_fleet_stages_add_up_and_match_the_trace(dev):
    s, b, h, w = 4, 4, 1080, 1920
    eng = MultiStreamEngine(_cfg(h, w, b, 640, "bfloat16"), s,
                            devices=[dev])
    assert eng.step_mode == "graph"
    fleet = _fleet(7, s, b, h, w)
    eng.process_batch(*fleet[0])                  # the capture
    stamps = eng.engine.stage_stamps
    for frames, ts in fleet[1:3]:
        eng.process_batch(frames, ts)
        got = stamps.cpu().tolist()
        assert got[0] < got[1] < got[2] < got[3]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for frames, ts in fleet[3:]:
            eng.process_batch(frames, ts)
        torch.cuda.synchronize()
    seen = _mark_intervals(prof)
    assert all(len(v) == 4 for v in seen.values()), seen
    durations = _durations(eng.timer, range(7))
    for k in range(7):
        assert sum(durations[(n, k)] for n in DEVICE_STAGES) \
            == durations[(DEVICE_STEP, k)]
    assert eng.timer.count[DEVICE_STEP] == 7
    for name in DEVICE_STAGES:
        marked = sum(durations[(name, k)] for k in range(3, 7))
        traced = sum(seen[name])
        assert abs(marked - traced) <= STAGE_TOL * traced, (name, marked,
                                                             traced)


def test_timer_spans_share_the_profilers_clock(dev):
    timer = StageTimer()
    torch.cuda._sleep(1000)                       # build the kernel
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with timer.stage("rvt_clock_check"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and e.name() != "rvt_clock_check"]
    sleep = max(kernels, key=lambda e: e.duration_ns())
    k0, k1 = sleep.start_ns(), sleep.start_ns() + sleep.duration_ns()
    _, t0, t1, _ = timer.spans[-1]
    assert k1 - k0 > 1_000_000, sleep.name()
    assert t0 - CLOCK_TOL_NS <= k0 and k1 <= t1 + CLOCK_TOL_NS, \
        (t0, k0, k1, t1)


def test_marks_change_no_fleet_output(dev):
    """The fleet replayed with marks, replayed without them (no stamp
    buffer) and run eagerly with them: the same detections, ids,
    distances and speeds, batch after batch."""
    s, b, h, w = 4, 2, 288, 480
    cfg = _cfg(h, w, b, 160)
    marked, unmarked, eager = (MultiStreamEngine(cfg, s, devices=[dev])
                               for _ in range(3))
    unmarked.engine.stage_stamps = None
    eager.groups[0].engine.step_mode = "eager"
    got = {id(e): [] for e in (marked, unmarked, eager)}
    for frames, ts in _fleet(4, s, b, h, w):
        for e in (marked, unmarked, eager):
            got[id(e)].append(e.process_batch(frames, ts))
    assert marked.timer.count[DEVICE_STEP] == 4
    assert eager.timer.count[DEVICE_STEP] == 4
    assert DEVICE_STEP not in unmarked.timer.count
    n = 0
    for m, u, e in zip(*got.values()):
        for ms, us, es in zip(m, u, e):
            for a, c, d in zip(ms, us, es):
                assert a.detections == c.detections == d.detections
                n += len(a.detections)
    assert n > 0


def test_single_stream_replay_records_its_stages(dev):
    """``PipelineEngine``'s replayed step marks too, and its arrays equal
    the same step replayed without marks, bit for bit."""
    h, w, b = 288, 480, 4
    cfg = _cfg(h, w, b, 160)
    marked, unmarked = (PipelineEngine(cfg, device=dev) for _ in range(2))
    unmarked.stage_stamps = None
    outs = {id(marked): [], id(unmarked): []}
    for k, (frames, ts) in enumerate(_fleet(3, 1, b, h, w)):
        for eng in (marked, unmarked):
            eng.process_batch(frames[0], ts[0], want_proc=False)
            x = torch.from_numpy(frames[0]).to(dev)
            t = torch.from_numpy((ts[0] - 1000.0).astype(np.float32)).to(dev)
            _, arrays = eng.step_batch(x, t, want_proc=False)
            outs[id(eng)].append([a.cpu().clone() for a in arrays])
    durations = _durations(marked.timer, range(3))
    for k in range(3):
        assert sum(durations[(n, k)] for n in DEVICE_STAGES) \
            == durations[(DEVICE_STEP, k)] > 0
    assert not [n for n in unmarked.timer.count if n.startswith("device.")]
    for g, e in zip(*outs.values()):
        for a, c in zip(g, e):
            assert torch.equal(a, c) or torch.allclose(
                a, c, rtol=0, atol=0, equal_nan=True)
