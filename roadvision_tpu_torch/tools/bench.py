"""The port's benchmark: one JSON line on stdout, detail on stderr.

    python -m roadvision_tpu_torch.tools.bench [--mode full] [--res 1080]
        [--batch 8] [--iters 16] [--windows 5] [--dtype bfloat16]
        [--model W.npz] [--device cuda|cpu]

The configuration is ``bench.py::_cfg(1080, 1920, 8)``, the default
realtime pipeline (CLAHE → median → YOLOv8n → NMS → SORT → geometry),
with the checked-in demo checkpoint unless ``--model`` names another
(an RT-DETR checkpoint runs the NMS-free detector; ``RVT_BENCH_NQ`` and
``RVT_BENCH_DECL`` set its ``num_queries`` and ``decoder_layers``, as
the JAX bench reads them).
``--mode full`` gives, each as the median of ``--windows`` windows of
``--iters`` batches with the windows' minimum and maximum beside it:

  * ``host_fed_process_batch_fps`` — frames from host memory through
    ``PipelineEngine.process_batch(want_proc=False)``, one batch at a time;
  * ``host_fed_stream_fps`` — the same frames through
    ``PipelineEngine.stream``: a reader thread starts each upload, two
    batches in flight;
  * ``device_resident_fps`` — frames rendered on the device by
    ``DeviceSyntheticSource``; only results cross the bus;

and ``stage_ms`` (one batch, each stage synchronised), ``timer_ms`` (the
engine's ``StageTimer`` means over the stream windows: decode, upload,
device_step, host_unpack), ``launches_per_batch`` of the hand-written
kernels, batch, iterations, dtype, and the card's name and power limit
as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them.

Other modes: ``preprocess`` (the chain alone), ``detect`` (no chain, no
tracker), ``nopre`` (the pipeline without the chain), and ``seg``,
``pose``, ``obb`` (the pipeline with a random-init task head, as the
JAX bench) run the same three measurements; ``sort`` (the tracker step
over synthetic detections), ``geometry`` (homography + distance
calls/s) and ``record`` (host overlay + compare canvas + MJPEG encode
frames/s) time one layer. ``gate`` is the JAX bench's temporal-gate
A/B (``bench.py::gate_fps``): the gated step
(``PipelineEngine.build_gated_scan_step``, each batch decided on its own
motion score, one host read a batch) against the plain step on a static
scene (one corner pixel's lowest bit flipped per frame, so the detector
input changes while the gate sees no motion) and on the moving scene,
frames/s each with the coasted share; then the staleness of coasted
boxes on a slow scene (the demo checkpoint and scene when present, one
scene step every 4 batches): matched IoU of the coasted detections
against the fresh ones. ``RVT_BENCH_GATE_SKIP`` sets
``max_skip_batches`` (default 7). ``streams`` is the camera fleet
(``bench_streams``): ``RVT_BENCH_STREAMS`` streams (default 4) at
``RVT_BENCH_RES`` lines (default 480; ``--res`` does not apply, as in the
JAX bench) through one fleet step, aggregate frames/s
(``streams{S}_{res}p_fps``), frames/s per stream, launches and host
syncs per fleet batch, and the fleet step's stage ms.

Timing: warm-up outside every window, ``torch.cuda.synchronize()`` at
both ends of a window, host clock between. ``--device cpu`` rehearses the
program on the plain PyTorch path (use a small ``--res``); its line says
``"platform": "cpu"`` and carries no card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import DEFAULTS, merge, project_root
from ..io_video import DeviceSyntheticSource, SyntheticRoadSource
from ..runtime import PipelineEngine
from ..utils.device import resolve_device
from ..utils.resolutions import res_width

FULL_MODES = ("full", "preprocess", "detect", "nopre", "seg", "pose", "obb")
LAYER_MODES = ("sort", "geometry", "record", "gate", "streams")
FPS = 30.0
DEMO_MODEL = "assets/yolov8n_synthetic_256.npz"


def _rtdetr_overrides(model: str) -> Dict[str, Any]:
    """``RVT_BENCH_NQ`` (detect.num_queries) and ``RVT_BENCH_DECL``
    (detect.decoder_layers), read as ``bench.py`` reads them: RT-DETR
    knobs, which the YOLO families ignore (a warning says so)."""
    nq, decl = os.environ.get("RVT_BENCH_NQ"), os.environ.get("RVT_BENCH_DECL")
    if (nq or decl) and "rtdetr" not in os.path.basename(model).lower():
        print("[bench] RVT_BENCH_NQ / RVT_BENCH_DECL are set but --model is "
              "not an rtdetr checkpoint: they only affect the rtdetr "
              "family and will be ignored", file=sys.stderr)
    return {"num_queries": int(nq) if nq else None,
            "decoder_layers": int(decl) if decl else None}


def bench_cfg(height: int, width: int, batch: int, model: str,
              dtype: str = "bfloat16") -> Dict[str, Any]:
    """``bench.py::_cfg(height, width, batch)`` with ``model``.
    ``dtype`` "int8-static" is int8 with static activation scales from
    the first 16 frames the detector sees (``detect.int8_calibration``,
    the JAX bench's ``RVT_BENCH_DTYPE=int8-static``); ``RVT_BENCH_SAMPLED=1``
    sets ``tpu.sampled_preprocess``, as the JAX bench reads it."""
    static = dtype == "int8-static"
    return merge(DEFAULTS, {
        "preprocess": {"enabled": True, "chain": [
            {"name": "CLAHEDehaze",
             "params": {"space": "YCrCb", "clip_limit": 2.0, "tile_grid": 8}},
            {"name": "MedianDerain", "params": {"ksize": 3}},
        ]},
        "detect": {"enabled": True, "model": model, "conf_thres": 0.25,
                   "iou_thres": 0.7, "max_det": 100,
                   "classes_keep": [0, 2, 3, 5, 7],
                   "int8_calibration": 16 if static else 0,
                   **_rtdetr_overrides(model)},
        "tracking": {"enabled": True, "max_staleness": 1.2, "min_hits": 3,
                     "iou_threshold": 0.35, "speed_window": 0.8},
        "geometry": {"enabled": True, "projector": {
            "type": "homography",
            "image_points": [[0, height], [width, height],
                             [0, int(0.4 * height)],
                             [width, int(0.4 * height)]],
            "world_points": [[0, 0], [20, 0], [0, 120], [20, 120]],
            "origin": [10.0, 0.0], "max_distance": 1000.0}},
        "tpu": {"batch_size": batch,
                "compute_dtype": "int8" if static else dtype,
                "sampled_preprocess":
                    os.environ.get("RVT_BENCH_SAMPLED", "0") == "1"},
    })


MODE_OVERRIDES = {
    "full": {},
    "preprocess": {"detect": {"enabled": False},
                   "tracking": {"enabled": False},
                   "geometry": {"enabled": False}},
    "detect": {"preprocess": {"enabled": False},
               "tracking": {"enabled": False},
               "geometry": {"enabled": False}},
    "nopre": {"preprocess": {"enabled": False}},
    # the full pipeline with a task head (random init, as the JAX bench):
    # masks, keypoints or rotated boxes ride the copy back as an 8th array
    "seg": {"detect": {"model": "yolov8n-seg.pt", "task": "segment"}},
    "pose": {"detect": {"model": "yolov8n-pose.pt", "task": "pose",
                        "classes_keep": []}},
    "obb": {"detect": {"model": "yolov8n-obb.pt", "task": "obb",
                       "classes_keep": []}},
}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def windows_fps(run: Callable[[], int], windows: int,
                device: torch.device) -> Dict[str, Any]:
    """``run()`` does one window's work and returns its frame count;
    each window is timed between two synchronisations."""
    vals = []
    for _ in range(windows):
        _sync(device)
        t0 = time.perf_counter()
        n = run()
        _sync(device)
        vals.append(n / (time.perf_counter() - t0))
    return {"median": float(np.median(vals)), "min": min(vals),
            "max": max(vals), "windows": vals}


class ReplaySource:
    """Pre-rendered batches served in a cycle with paced timestamps: the
    decode cost is kept out of the host-fed numbers."""

    def __init__(self, batches: List[np.ndarray], t0: float = 1000.0):
        self.batches = batches
        self.k = 0
        self.t0 = t0

    def read_batch(self, n: int) -> Tuple[np.ndarray, np.ndarray, int]:
        frames = self.batches[self.k % len(self.batches)][:n]
        m = frames.shape[0]
        ts = self.t0 + (self.k * len(self.batches[0]) + np.arange(m)) / FPS
        self.k += 1
        return frames, ts, m

    def release(self) -> None:
        pass


def render_batches(width: int, height: int, batch: int, n: int,
                   seed: int = 0) -> List[np.ndarray]:
    src = SyntheticRoadSource(width, height, num_vehicles=6, seed=seed)
    return [np.stack([src.render(k * batch + i) for i in range(batch)])
            for k in range(n)]


def host_fed_process_batch(engine, source: ReplaySource, iters: int) -> int:
    n = 0
    for _ in range(iters):
        frames, ts, _ = source.read_batch(engine.batch_size)
        n += len(engine.process_batch(frames, ts, want_proc=False))
    return n


def host_fed_stream(engine, source: ReplaySource, iters: int) -> int:
    return sum(1 for _ in engine.stream(
        source, max_frames=iters * engine.batch_size, want_proc=False))


def device_resident(engine, render, k0: int, iters: int) -> Tuple[int, int]:
    """``iters`` batches rendered on the device through ``engine.step``,
    results copied back through pinned buffers, two batches in flight.
    Returns (frames, tracked detections)."""
    b = engine.batch_size
    dev = engine.device
    steps = torch.arange(b, device=dev, dtype=torch.float32) / FPS
    pending: list = []
    tracked = 0

    def finish(item) -> int:
        bufs, key, done = item
        if done is None:
            arrays = [t.numpy() for t in bufs]
        else:
            done.synchronize()
            arrays = [t.numpy().copy() for t in bufs]
            engine.recycle(key, bufs)
        return int(((arrays[4] > 0) & arrays[3]).sum())

    for k in range(k0, k0 + iters):
        frames = render(k * b)
        _, arrays = engine.step(frames, k * b / FPS + steps, want_proc=False)
        pending.append(engine.download(list(arrays)) if dev.type == "cuda"
                       else (list(arrays), None, None))
        if len(pending) >= 2:
            tracked += finish(pending.pop(0))
    while pending:
        tracked += finish(pending.pop(0))
    return iters * b, tracked


def stage_ms(engine, frames: np.ndarray, ts: np.ndarray) -> Dict[str, float]:
    """Host-clock ms of each stage of one step, synchronised between."""
    dev = engine.device
    out: Dict[str, float] = {}
    h, w = frames.shape[1:3]
    x = torch.from_numpy(frames).to(dev)
    tsd = torch.from_numpy((ts - ts[0]).astype(np.float32)).to(dev)

    def timed(name, fn):
        _sync(dev)
        t0 = time.perf_counter()
        r = fn()
        _sync(dev)
        out[name] = (time.perf_counter() - t0) * 1e3
        return r

    det = engine.detector
    with torch.inference_mode():
        proc = timed("preprocess", lambda: engine.pipeline.apply_batch(x))
        if det is None:
            return out
        lb = timed("letterbox", lambda: det.letterbox(proc))
        # the detector's forwards (TTA's three, every tile), then its NMS
        # and the task's side output
        raw, ratio, pad = timed("forward", lambda: det.candidates(proc, lb))
        b, c, k, v, _ = timed("nms", lambda: det.postprocess(
            raw, ratio, pad, (h, w)))
        state, gmc_prev = engine.sort_state, engine._gmc_prev
        # the tracker tail with what it computes beside the steps: the
        # re-id descriptors and the GMC shifts, as the engine runs it
        timed("sort_geometry", lambda: engine._dets_tail(
            frames.shape[0], b, c, k, v, tsd, x,
            engine._gmc_shifts(x) if engine.gmc_enabled else None))
        engine.sort_state, engine._gmc_prev = state, gmc_prev   # no trace
    return out


def bench_pipeline(args, device: torch.device) -> Dict[str, Any]:
    height, width, batch = args.res, res_width(args.res), args.batch
    cfg = merge(bench_cfg(height, width, batch, args.model, args.dtype),
                MODE_OVERRIDES[args.mode])
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    engine = PipelineEngine(cfg, device=device, seed=args.seed)
    batches = render_batches(width, height, batch, 4, seed=args.seed)
    dsrc = DeviceSyntheticSource(width, height, num_vehicles=6,
                                 seed=args.seed, device=device)
    render = dsrc.make_render_fn(batch)
    iters, wins = args.iters, args.windows
    out: Dict[str, Any] = {}

    # host-fed, one batch at a time
    src = ReplaySource(batches)
    host_fed_process_batch(engine, src, args.warmup)
    kernels.reset_launch_counts()
    out["host_fed_process_batch_fps"] = windows_fps(
        lambda: host_fed_process_batch(engine, src, iters), wins, device)
    out["launches_per_batch"] = {
        k: v / (iters * wins) for k, v in kernels.launch_counts.items()}
    print(f"[bench] process_batch: "
          f"{out['host_fed_process_batch_fps']['median']:.1f} frames/s",
          file=sys.stderr)

    # host-fed through stream (reader-side upload, two in flight)
    engine.reset()
    src = ReplaySource(batches)
    host_fed_stream(engine, src, max(2, args.warmup))
    engine.timer = type(engine.timer)()
    out["host_fed_stream_fps"] = windows_fps(
        lambda: host_fed_stream(engine, src, iters), wins, device)
    out["timer_ms"] = {k: engine.timer.p50_ms(k) for k in engine.timer.total}
    print(f"[bench] stream: {out['host_fed_stream_fps']['median']:.1f} "
          f"frames/s; timer {engine.timer.summary()}", file=sys.stderr)

    # device-resident
    engine.reset()
    device_resident(engine, render, 0, args.warmup)
    state = {"k": args.warmup, "tracked": 0, "frames": 0}

    def run_resident() -> int:
        n, tracked = device_resident(engine, render, state["k"], iters)
        state["k"] += iters
        state["tracked"] += tracked
        state["frames"] += n
        return n

    out["device_resident_fps"] = windows_fps(run_resident, wins, device)
    out["mean_tracks_per_frame"] = state["tracked"] / max(1, state["frames"])
    print(f"[bench] device-resident: "
          f"{out['device_resident_fps']['median']:.1f} frames/s, "
          f"{out['mean_tracks_per_frame']:.2f} tracked objects a frame",
          file=sys.stderr)

    engine.reset()
    ts = 1000.0 + np.arange(batch) / FPS
    engine.process_batch(batches[0], ts, want_proc=False)
    out["stage_ms"] = stage_ms(engine, batches[1], ts + batch / FPS)
    out["metric"] = f"{'pipeline' if args.mode == 'full' else args.mode}" \
                    f"_{height}p_fps"
    out["value"] = out["device_resident_fps"]["median"]
    out["unit"] = "frames/sec"
    return out


def bench_sort(args, device: torch.device) -> Dict[str, Any]:
    """The tracker step over synthetic detections: 12 moving boxes a
    frame, capacity 100, 64 slots (``bench.py::sort_only_fps``)."""
    from ..track.sort import init_state, make_sort_step
    n_frames, dets, cap, slots = 32 * args.iters, 12, 100, 64
    rng = np.random.RandomState(args.seed)
    boxes = np.zeros((n_frames, cap, 4), np.float32)
    valid = np.zeros((n_frames, cap), bool)
    pos = rng.uniform(50, 800, (dets, 2))
    vel = rng.uniform(-4, 4, (dets, 2))
    for f in range(n_frames):
        xy = pos + vel * f
        boxes[f, :dets] = np.concatenate([xy, xy + (50, 45)], axis=1)
        valid[f, :dets] = True
    tb = torch.from_numpy(boxes).to(device)
    tv = torch.from_numpy(valid).to(device)
    cls = torch.full((cap,), 2, dtype=torch.int32, device=device)
    conf = torch.full((cap,), 0.9, device=device)
    ts = torch.arange(n_frames, dtype=torch.float32, device=device) / FPS
    step = make_sort_step(0.35, 1.2, 0.8)

    @torch.inference_mode()
    def run() -> int:
        state = init_state(slots, device)
        for f in range(n_frames):
            state, _ = step(state, tb[f], cls, conf, tv[f], ts[f], None)
        return n_frames

    run()
    fps = windows_fps(run, args.windows, device)
    return {"metric": "sort_tracker_fps", "value": fps["median"],
            "unit": "frames/sec", "sort_tracker_fps": fps}


def bench_geometry(args, device: torch.device) -> Dict[str, Any]:
    """Homography projection + clamped distance of 100 boxes a call
    (``bench.py::geometry_only_fps``)."""
    from ..geometry.projector import (build_projector, distance_device,
                                      project_boxes_device)
    proj = build_projector({"projector": {
        "type": "homography",
        "image_points": [[0, 1080], [1920, 1080], [0, 432], [1920, 432]],
        "world_points": [[0, 0], [20, 0], [0, 120], [20, 120]],
        "origin": [10.0, 0.0], "max_distance": 1000.0}}, device=device)
    h_mat, origin, maxd = proj.device_params()
    rng = np.random.RandomState(args.seed)
    b0 = np.zeros((100, 4), np.float32)
    b0[:, 0] = rng.uniform(0, 1800, 100)
    b0[:, 1] = rng.uniform(440, 1000, 100)
    b0[:, 2] = b0[:, 0] + rng.uniform(30, 120, 100)
    b0[:, 3] = b0[:, 1] + rng.uniform(20, 80, 100)
    drift = torch.tensor([0.0, 2.0, 0.0, 2.0], device=device)
    calls = 16 * args.iters

    @torch.inference_mode()
    def run() -> int:
        bx = torch.from_numpy(b0).to(device)
        for _ in range(calls):
            g, v = project_boxes_device(h_mat, bx)
            distance_device(g, v, origin, maxd)
            bx = bx + drift
        return calls

    run()
    rate = windows_fps(run, args.windows, device)
    return {"metric": "homography_batch100_calls_per_sec",
            "value": rate["median"], "unit": "calls/sec",
            "homography_batch100_calls_per_sec": rate}


def bench_record(args) -> Dict[str, Any]:
    """Host overlay + compare canvas + MJPEG encode + mux through the
    real writer, on moving road-like content with 12 tracked boxes
    (``bench.py::sustained_record_fps``). Host work only."""
    from ..detect.types import Detection
    from ..io_video.writer import MJPEGAVIWriter, encode_jpeg_bgr
    from ..vis import draw_detections, make_canvas
    height, width = args.res, res_width(args.res)
    quality = int(DEFAULTS["preview"]["record"]["quality"])
    rng = np.random.RandomState(args.seed)
    base = (np.linspace(0, 200, width)[None, :, None]
            + np.linspace(0, 55, height)[:, None, None])
    frame = np.clip(base + rng.normal(0, 8, (height, width, 3)),
                    0, 255).astype(np.uint8)
    ring = [np.roll(frame, 45 * i, axis=0) for i in range(24)]

    def dets_at(k: int):
        out = []
        for i in range(12):
            x1 = float(20 + 80 * i + 3 * k) % (width - 120)
            y1 = float(30 + 53 * i + 2 * k) % (height - 90)
            out.append(Detection(x1, y1, x1 + 100, y1 + 70, 0.8, 2, "car",
                                 track_id=i + 1, distance_m=25.0 + i,
                                 speed_kmh=40.0 + i))
        return out

    def canvas_at(k: int) -> np.ndarray:
        raw = ring[k % len(ring)]
        canvas = make_canvas(raw, raw, layout="h", divider_px=4,
                             label_raw="RAW", label_proc="PROC",
                             fps=FPS, show_fps=True)
        draw_detections(canvas[:, width + 4:], dets_at(k))
        return canvas

    canvas0 = canvas_at(0)
    t0 = time.perf_counter()
    for _ in range(8):
        encode_jpeg_bgr(canvas0, quality)
    enc_ms = (time.perf_counter() - t0) / 8 * 1e3
    n_frames = 8 * args.iters
    vals = []
    with tempfile.TemporaryDirectory() as tmp:
        for w in range(args.windows):
            writer = MJPEGAVIWriter(os.path.join(tmp, f"w{w}.avi"), fps=FPS,
                                    quality=quality)
            for k in range(4):      # open the file, start the pool
                writer.write(canvas_at(k))
            t0 = time.perf_counter()
            try:
                for k in range(n_frames):
                    writer.write(canvas_at(k))
            finally:
                writer.release()    # waits for the encodes in flight
            vals.append(n_frames / (time.perf_counter() - t0))
    fps = {"median": float(np.median(vals)), "min": min(vals),
           "max": max(vals), "windows": vals}
    return {"metric": f"record_tail_{height}p_sustained_fps",
            "value": fps["median"], "unit": "frames/sec",
            "record_tail_fps": fps, "jpeg_encode_ms": enc_ms,
            "jpeg_quality": quality, "canvas": [2 * width + 4, height],
            "host_cpus": os.cpu_count()}


def _best_ious(got: np.ndarray, want: np.ndarray) -> List[float]:
    """For each box of ``got``, its best IoU against ``want`` (0 when
    ``want`` is empty)."""
    out = []
    for a in got:
        if len(want) == 0:
            out.append(0.0)
            continue
        ix = np.maximum(0, np.minimum(a[2], want[:, 2])
                        - np.maximum(a[0], want[:, 0]))
        iy = np.maximum(0, np.minimum(a[3], want[:, 3])
                        - np.maximum(a[1], want[:, 1]))
        inter = ix * iy
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (want[:, 2] - want[:, 0]) * (want[:, 3] - want[:, 1]) - inter)
        out.append(float((inter / np.maximum(ua, 1e-9)).max()))
    return out


def bench_gate(args, device: torch.device) -> Dict[str, Any]:
    """The temporal-gate A/B of ``bench.py::gate_fps``: gated against
    ungated on a static and on a moving scene, and the staleness of the
    coasted boxes on a slow one."""
    from ..config import load_config
    height, width, batch = args.res, res_width(args.res), args.batch
    base = bench_cfg(height, width, batch, args.model, args.dtype)
    gate = {"enable": True, "max_skip_batches": int(
        os.environ.get("RVT_BENCH_GATE_SKIP", "7"))}
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    eng_on = PipelineEngine(merge(base, {"detect": {"temporal_gate": gate}}),
                            device=device, seed=args.seed)
    eng_off = PipelineEngine(base, device=device, seed=args.seed)
    shape = (batch, height, width)
    step, init_carry = eng_on.build_gated_scan_step(shape)
    render_at = DeviceSyntheticSource(width, height, num_vehicles=6,
                                      seed=args.seed,
                                      device=device).make_render_at_fn()
    steps = torch.arange(batch, device=device)
    out: Dict[str, Any] = {}

    for scene in ("static", "moving"):
        still = render_at(torch.zeros((batch,), dtype=torch.long,
                                      device=device))
        box = {"k": 0, "carry": init_carry(), "coasted": 0, "frames": 0}

        def frames_at(k: int) -> torch.Tensor:
            idx = k * batch + steps
            if scene == "moving":
                return render_at(idx)
            # flip one corner pixel's lowest bit per frame: the detector
            # input changes every batch, the gate's thumbnail does not
            f = still.clone()
            f[:, 0, 0, 0] = (idx % 2).to(torch.uint8)
            return f

        def gated() -> int:
            for _ in range(args.iters):
                k = box["k"]
                ts = (k * batch + steps).to(torch.float32) / FPS
                outs, coast, box["carry"] = step(box["carry"], frames_at(k),
                                                 ts)
                box["coasted"] += batch if coast else 0
                box["frames"] += batch
                box["k"] += 1
            return args.iters * batch

        def plain() -> int:
            for _ in range(args.iters):
                k = box["k"]
                ts = (k * batch + steps).to(torch.float32) / FPS
                eng_off.step(frames_at(k), ts, want_proc=False)
                box["k"] += 1
            return args.iters * batch

        for run in (gated, plain):
            box["k"] = 0
            for _ in range(args.warmup):
                run()
        box.update(k=args.warmup * args.iters, coasted=0, frames=0)
        eng_off.reset()
        on = windows_fps(gated, args.windows, device)
        off = windows_fps(plain, args.windows, device)
        out[scene] = {"gated_fps": on, "ungated_fps": off,
                      "speedup": on["median"] / off["median"],
                      "coasted_share": box["coasted"] / max(1, box["frames"]),
                      "frames_coasted": box["coasted"]}
        print(f"[bench] gate, {scene} {height}p scene: "
              f"{on['median']:.1f} frames/s gated vs {off['median']:.1f} "
              f"ungated, {box['coasted']} of {box['frames']} frames coasted",
              file=sys.stderr)

    # staleness on a slow scene: real detections from the demo checkpoint
    # and its scene when present, one scene step every 4 batches
    s_base, s_w, s_h, n_veh = base, width, height, 6
    demo = project_root() / "configs" / "synthetic_demo.yaml"
    ckpt = project_root() / DEMO_MODEL
    if demo.exists() and ckpt.exists():
        s_base = load_config(str(demo))
        s_base["tpu"]["batch_size"] = batch
        s_base["detect"]["model"] = str(ckpt)
        s_h, s_w = int(s_base["camera"]["height"]), \
            int(s_base["camera"]["width"])
        tail = str(s_base["camera"]["source"]).rpartition(":")[2]
        n_veh = int(tail) if tail.isdigit() else 4
    s_on = PipelineEngine(merge(s_base, {"detect": {"temporal_gate": {
        "enable": True, "max_skip_batches": 7}}}), device=device,
        seed=args.seed)
    s_off = PipelineEngine(s_base, device=device, seed=args.seed)
    s_step, s_init = s_on.build_gated_scan_step((batch, s_h, s_w))
    s_render = DeviceSyntheticSource(s_w, s_h, num_vehicles=n_veh,
                                     device=device).make_render_at_fn()
    slow = 4 * batch
    carry = s_init()
    ious, n_coasted = [], 0
    n_stale = min(max(args.iters, 2) * 2, 16)
    for k in range(n_stale):
        idx = k * batch + steps
        frames = s_render(idx // slow)
        ts = idx.to(torch.float32) / FPS
        outs_g, coast, carry = s_step(carry, frames, ts)
        _, outs_p = s_off.step(frames, ts, want_proc=False)
        if not coast:
            continue
        gb, gv, pb, pv = (t.cpu().numpy() for t in
                          (outs_g[0], outs_g[3], outs_p[0], outs_p[3]))
        for f in range(batch):
            n_coasted += 1
            ious += _best_ious(gb[f][gv[f]], pb[f][pv[f]])
    out["staleness"] = {
        "coast_frac": n_coasted / (n_stale * batch),
        "iou_mean": float(np.mean(ious)) if ious else 1.0,
        "iou_min": float(np.min(ious)) if ious else 1.0,
        "n_dets": len(ious), "slow_factor": slow}
    print(f"[bench] gate staleness on a slow scene (1 scene step per {slow} "
          f"frames): coast_frac={out['staleness']['coast_frac']:.2f}, "
          f"matched IoU vs fresh mean={out['staleness']['iou_mean']:.3f} "
          f"min={out['staleness']['iou_min']:.3f} over "
          f"{out['staleness']['n_dets']} coasted dets", file=sys.stderr)
    out.update({"metric": f"gate_static_{height}p_fps",
                "value": out["static"]["gated_fps"]["median"],
                "unit": "frames/sec"})
    return out


def fleet_stage_ms(engine, frames: torch.Tensor, ts: torch.Tensor,
                   states) -> Dict[str, float]:
    """Host-clock ms of each stage of one fleet step, synchronised
    between: the folded (S·B) batch through preprocess, letterbox, the
    detector's forward and NMS, then every stream's tracker tail on a
    copy of ``states``, the fleet's running state (left as it was, as
    :func:`stage_ms` leaves the engine's)."""
    from ..parallel.inference import _fold, _stream_tails, _unfold
    from ..track.sort import SortState
    if states is not None:
        states = SortState(*[t.clone() for t in states])
    dev = engine.device
    s = frames.shape[0]
    out: Dict[str, float] = {}

    def timed(name, fn):
        _sync(dev)
        t0 = time.perf_counter()
        r = fn()
        _sync(dev)
        out[name] = (time.perf_counter() - t0) * 1e3
        return r

    det = engine.detector
    h, w = frames.shape[2:4]
    with torch.inference_mode():
        proc = timed("preprocess",
                     lambda: engine.pipeline.apply_batch(_fold(frames)))
        lb = timed("letterbox", lambda: det.letterbox(proc))
        raw, ratio, pad = timed("forward", lambda: det.candidates(proc, lb))
        dets4 = timed("nms", lambda: det.postprocess(raw, ratio, pad, (h, w)))
        dets4 = tuple(_unfold(a, s) for a in dets4[:4])
        timed("sort_geometry", lambda: _stream_tails(
            engine, states, frames.shape[1], dets4, ts, frames))
    return out


def bench_streams(args, device: torch.device) -> Dict[str, Any]:
    """The camera fleet (``bench.py::streams_fps``): ``RVT_BENCH_STREAMS``
    streams (default 4) of ``RVT_BENCH_RES``-line frames (default 480)
    rendered on the device, through the fleet step
    (``parallel/inference.py::make_stream_step``: one folded batch for
    preprocess and the detector, the tracker tail per stream), results
    copied back through pinned buffers, two batches in flight. Reports
    the aggregate frames/s of all streams, frames/s per stream, the
    kernels' launches and the association's host syncs per fleet batch,
    and the fleet step's stage ms."""
    from ..parallel.inference import make_stream_step
    from ..track import sort as tsort
    n_streams = int(os.environ.get("RVT_BENCH_STREAMS", "4"))
    height = int(os.environ.get("RVT_BENCH_RES", "480"))
    width, batch = res_width(height), args.batch
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    engine = PipelineEngine(bench_cfg(height, width, batch, args.model,
                                      args.dtype), device=device,
                            seed=args.seed)
    step, init_states = make_stream_step(engine, (batch, height, width))
    render = DeviceSyntheticSource(width, height, num_vehicles=6,
                                   seed=args.seed, device=device) \
        .make_render_fn(n_streams * batch)
    fleet = n_streams * batch
    state = {"k": 0, "states": init_states(n_streams)}

    def inputs(k: int):
        # as the JAX bench: S·B consecutive scene frames, stamped by index
        idx0 = k * fleet
        frames = render(idx0).reshape(n_streams, batch, height, width, 3)
        ts = (idx0 + torch.arange(fleet, dtype=torch.float32, device=device)
              ).reshape(n_streams, batch) / FPS
        return frames, ts

    def finish(item) -> None:
        bufs, key, done = item
        done.synchronize()
        engine.recycle(key, bufs)

    def run_batches(iters: int) -> int:
        pending: list = []
        for _ in range(iters):
            outs, state["states"] = step(state["states"], *inputs(state["k"]))
            state["k"] += 1
            if device.type == "cuda":
                pending.append(engine.download(list(outs)))
                if len(pending) >= 2:
                    finish(pending.pop(0))
        for item in pending:
            finish(item)
        return iters * fleet

    run_batches(args.warmup)
    kernels.reset_launch_counts()
    fps = windows_fps(lambda: run_batches(args.iters), args.windows, device)
    out: Dict[str, Any] = {"streams": n_streams, "res": height,
                           "streams_fps": fps}
    out["launches_per_batch"] = {
        k: v / (args.iters * args.windows)
        for k, v in kernels.launch_counts.items()}
    out["per_stream_fps"] = {k: fps[k] / n_streams
                             for k in ("median", "min", "max")}
    tsort.reset_host_syncs()
    run_batches(1)
    out["host_syncs_per_batch"] = tsort.host_syncs
    out["stage_ms"] = fleet_stage_ms(engine, *inputs(state["k"]),
                                     state["states"])
    print(f"[bench] streams: {n_streams} x {height}p x batch {batch}: "
          f"{fps['median']:.1f} frames/s in all, "
          f"{out['per_stream_fps']['median']:.1f} a stream; "
          f"{out['host_syncs_per_batch']} host syncs a fleet batch",
          file=sys.stderr)
    out.update({"metric": f"streams{n_streams}_{height}p_fps",
                "value": fps["median"], "unit": "frames/sec"})
    return out


def run(args) -> Dict[str, Any]:
    device = resolve_device(args.device)
    if args.model is None:
        args.model = str(project_root() / DEMO_MODEL)
    if args.mode in FULL_MODES:
        out = bench_pipeline(args, device)
    elif args.mode == "sort":
        out = bench_sort(args, device)
    elif args.mode == "geometry":
        out = bench_geometry(args, device)
    elif args.mode == "gate":
        out = bench_gate(args, device)
    elif args.mode == "streams":
        out = bench_streams(args, device)
    else:
        out = bench_record(args)
    on_card = device.type == "cuda"
    out.update({
        "mode": args.mode, "res": out.get("res", args.res),
        "batch": args.batch,
        "iters": args.iters, "windows": args.windows, "dtype": args.dtype,
        "model": os.path.basename(args.model),
        "card": card_line() if on_card else None,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": torch.cuda.device_count() if on_card else 0}})
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="full",
                    choices=[*FULL_MODES, *LAYER_MODES])
    ap.add_argument("--res", type=int, default=1080,
                    help="frame height; the width follows the bench table")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=16,
                    help="batches per timed window")
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2,
                    help="batches run before the first window of each "
                         "measurement")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "int8", "int8-static"])
    ap.add_argument("--model", default=None,
                    help=f"detector weights (default: {DEMO_MODEL})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or a "
                         "rehearsal on the CPU")
    args = ap.parse_args(argv)
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
