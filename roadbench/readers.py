"""What the per-layer metrics read, one function a quantity; each file
``metrics/<metric>.py`` names the function its metric is. A reader
takes the :class:`~roadbench.harness.Run` of a traced run and returns a
number, or None where it finds nothing to read (the metric is then
left out of the line)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import yardstick


def unpack_ms(run) -> Optional[float]:
    """The engine's own ``host_unpack`` stage (``StageTimer``): its total
    over the fleet batches of the window's untraced part divided by
    their count."""
    total, count = run.timer.get("host_unpack", (0.0, 0))
    return total / count * 1e3 if count else None


def dispatch_late_p95_ms(run) -> Optional[float]:
    """How late the open-loop generator dispatched: the 95th percentile
    of dispatch time less due time over the batches due before the
    profiler opened."""
    late = [s - d for s, d in zip(run.window.sent, run.window.due)
            if d < run.traced_from]
    return float(np.percentile(late, 95)) * 1e3 if late else None


def idle_share(run) -> Optional[float]:
    """1 - (union of the device's operation intervals) / wall time of
    the traced stretch, in %."""
    prof = run.profile
    if prof is None or prof.window_s <= 0 or not prof.kernels:
        return None
    return (1.0 - prof.busy_s / prof.window_s) * 100.0


def _folded(run):
    x, ts = run.fleet_batch()
    return x, ts, x.reshape(-1, *x.shape[2:])


def preprocess_ms(run) -> float:
    """The preprocess chain alone on one fleet batch (S·B frames),
    captured in a CUDA graph, device ms a replay."""
    _, _, fold = _folded(run)
    return yardstick.graph_ms(run.engine.engine.pipeline.apply_batch,
                              [fold])


def detector_ms(run) -> float:
    """Resize or letterbox, the forward and NMS or top-k on one fleet
    batch's processed frames, captured alone."""
    eng = run.engine.engine
    _, _, fold = _folded(run)
    with torch.inference_mode():
        proc = eng.pipeline.apply_batch(fold)
    return yardstick.graph_ms(eng.detector.run, [proc])


def tracker_ms(run) -> float:
    """The stacked tracker scan with its geometry over one fleet batch's
    detections (S streams × B frames), from fresh tracks, captured
    alone."""
    from roadvision_tpu_torch.track.multi import init_multi_state
    eng = run.engine.engine
    x, ts, fold = _folded(run)
    s, b = x.shape[:2]
    with torch.inference_mode():
        dets = eng.detector.run(eng.pipeline.apply_batch(fold))[:4]
        dets = [d.reshape(s, b, *d.shape[1:]) for d in dets]
        state = init_multi_state(s, eng.track_slots, run.device)
    return yardstick.graph_ms(lambda *a: eng._tail(state, b, *a),
                              [*dets, ts, x])


def step_mfu(run) -> Optional[float]:
    """The fleet step's detector FLOPs (counted from layer shapes at the
    detector's input size) times the fleet batches a second of the
    untraced part of the window, over the bf16 peak, in %."""
    rate = run.batches_per_s_untraced
    if not rate:
        return None
    cell = run.cell
    model = cell.config["model"]
    h, w = int(cell.traffic["height"]), int(cell.traffic["width"])
    size = int(model["imgsz"])
    if model["family"] == "yolov8":
        r = min(size / h, size / w)
        ih, iw = (-(-round(h * r) // 32) * 32, -(-round(w * r) // 32) * 32)
    else:
        ih = iw = size
    flops = yardstick.forward_flops(model, ih, iw, str(
        run.root / cell.config["checkpoint"]))
    return flops * cell.streams * cell.batch * rate \
        / yardstick.BF16_FLOPS_PER_S * 100.0


def _roofline(run, kernel: str, bound_s: float) -> Optional[float]:
    prof = run.profile
    if prof is None:
        return None
    n, seconds = prof.kernel_time(kernel)
    return n * bound_s / seconds * 100.0 if n and seconds > 0 else None


def _plane(run):
    t = run.cell.traffic
    return run.cell.streams * run.cell.batch, int(t["height"]), \
        int(t["width"])


def clahe_tile_luts_roofline(run) -> Optional[float]:
    n, h, w = _plane(run)
    return _roofline(run, "clahe_tile_luts_kernel",
                     yardstick.clahe_tile_luts_s(n, h, w))


def clahe_apply_roofline(run) -> Optional[float]:
    n, h, w = _plane(run)
    return _roofline(run, "clahe_apply_kernel",
                     yardstick.clahe_apply_s(n, h, w))


def median_k_roofline(run) -> Optional[float]:
    n, h, w = _plane(run)
    return _roofline(run, "median3_kernel", yardstick.median_k_s(3 * n, h, w))


def deform_sample_roofline(run) -> Optional[float]:
    """K7's launches in the traced stretch against its bound at the
    fleet batch: the value rows its corners touch are those the
    reference's sampling touches on four of the cell's frames."""
    from .reference import detect as rdetect
    from .reference import preprocess as rpre
    from .reference.params import load_npz
    from .reference.rtdetr import RowCounter
    if run.profile is None or not run.profile.kernel_time(
            "deform_sample_kernel")[0]:
        return None
    cell = run.cell
    pipe = cell.config["pipeline"]
    clahe, med = (c["params"] for c in pipe["preprocess"]["chain"])
    frames = run.pool[:4, 0]
    counter = RowCounter()
    p = load_npz(str(run.root / cell.config["checkpoint"]), run.device)
    with torch.no_grad():
        x = rpre.chain(frames, float(clahe["clip_limit"]),
                       int(clahe["tile_grid"]), int(med["ksize"]))
        rdetect.candidates(x, cell.config["model"], p, counter)
    rows = counter.rows / counter.calls / frames.shape[0]
    n = cell.streams * cell.batch
    return _roofline(run, "deform_sample_kernel", yardstick.deform_sample_s(
        n, int(cell.config["model"]["num_queries"]), rows * n))
