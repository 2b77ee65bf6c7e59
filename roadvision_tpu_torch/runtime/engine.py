"""Batched pipeline engine on the card — the port of
``roadvision_tpu/runtime/engine.py`` (the default realtime step).

One batch of BGR uint8 frames goes host → device once; on the device it
runs preprocess chain → letterbox → YOLOv8 forward → DFL decode → NMS →
box rescale → SORT over the batch's frames → geometry; the results come
back in one transfer. The track state stays on the device across
batches. :meth:`PipelineEngine.dispatch_batch` queues a batch without
waiting for its results; :meth:`PipelineEngine.stream` keeps two batches
in flight so the host's decode and unpack overlap the card's work.

With ``tpu.sampled_preprocess`` and ``want_proc=False``, where the
letterbox resize is an exact odd-stride slice on both axes (1080p → 640
is stride 3) and the chain has a sampled terminal op, the chain's last
op evaluates only the letterbox's sample grid and
:func:`finish_letterbox` pads the result: bit-equal detector input, no
full processed frame. An ``auto_gate.contrast_thresh: "auto"`` gate is
calibrated from the first batch, on the host, before that batch runs.

Config keys as in the JAX engine. Not ported yet, and raising at
construction: ``detect.temporal_gate``, ``tracking.gmc``, the tracker
backends other than greedy SORT, and what the detector refuses.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from ..detect.types import COCO_NAMES, Detection
from ..geometry.projector import (HomographyProjector, build_projector,
                                  distance_device, project_boxes_device)
from ..ops.letterbox import axis_plan, finish_letterbox, scale_boxes
from ..preprocess import PreprocessPipeline
from ..track.sort import build_sort_step, init_state
from ..utils.device import DeviceLike, resolve_device


class FrameResult(NamedTuple):
    raw: np.ndarray          # (H, W, 3) uint8 BGR
    proc: np.ndarray         # (H, W, 3) uint8 BGR
    detections: List[Detection]
    ts: float


def unpack_detections(arrays, names: List[str],
                      b: int) -> List[List[Detection]]:
    """Masked fixed-shape arrays (boxes, conf, cls, valid, ids, dist,
    speed) → per-frame ``Detection`` lists."""
    boxes, conf, cls_id, valid, ids, dist, speed = arrays
    fi, sj = np.nonzero(valid)
    vb = boxes[fi, sj].tolist()
    vconf = conf[fi, sj].tolist()
    vcls = cls_id[fi, sj].tolist()
    vids = ids[fi, sj].tolist()
    vdist, vspeed = dist[fi, sj], speed[fi, sj]
    dist_ok, speed_ok = np.isfinite(vdist), np.isfinite(vspeed)
    vdist, vspeed = vdist.tolist(), vspeed.tolist()
    per_frame: List[List[Detection]] = [[] for _ in range(b)]
    for n, (i, k) in enumerate(zip(fi.tolist(), vcls)):
        x1, y1, x2, y2 = vb[n]
        per_frame[i].append(Detection(
            x1, y1, x2, y2, vconf[n], k,
            names[k] if 0 <= k < len(names) else str(k),
            track_id=vids[n] if vids[n] > 0 else None,
            distance_m=vdist[n] if dist_ok[n] else None,
            speed_kmh=vspeed[n] if speed_ok[n] else None))
    return per_frame


class PipelineEngine:
    """Config-driven end-to-end engine. ``device`` defaults to the card;
    pass ``device="cpu"`` for the plain PyTorch path."""

    def __init__(self, cfg: Dict[str, Any], device: DeviceLike = None,
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        tpu_cfg = cfg.get("tpu", {}) or {}
        self.batch_size = int(tpu_cfg.get("batch_size", 8))
        self._sampled_pre = bool(tpu_cfg.get("sampled_preprocess", False))

        self.pipeline = PreprocessPipeline(cfg.get("preprocess", {}) or {},
                                           device=self.device)

        det_cfg = dict(cfg.get("detect", {}) or {})
        det_cfg.setdefault("compute_dtype",
                           tpu_cfg.get("compute_dtype", "bfloat16"))
        if (det_cfg.get("temporal_gate") or {}).get("enable"):
            raise NotImplementedError("detect.temporal_gate is not ported to "
                                      "roadvision_tpu_torch yet")
        self.detector = None
        if det_cfg.get("enabled", False):
            backend = str(det_cfg.get("backend") or "ultralytics").lower()
            if backend not in ("ultralytics", "jax", "yolov8", "torch"):
                raise NotImplementedError(
                    f"detect.backend {backend!r} is not ported to "
                    f"roadvision_tpu_torch yet")
            from ..detect.yolo_torch import YOLOTorch
            self.detector = YOLOTorch(det_cfg, device=self.device, seed=seed)
        self.max_det = int(det_cfg.get("max_det", 100))
        slots = tpu_cfg.get("track_slots")
        self.track_slots = int(slots) if slots else max(64, self.max_det)

        track_cfg = cfg.get("tracking", {}) or {}
        self.track_enabled = bool(track_cfg.get("enabled", False)) \
            and self.detector is not None
        self._sort_step = build_sort_step(track_cfg) \
            if self.track_enabled else None

        geom_cfg = cfg.get("geometry", {}) or {}
        self.projector: Optional[HomographyProjector] = None
        if geom_cfg.get("enabled", False):
            try:
                self.projector = build_projector(geom_cfg, device=self.device)
            except ValueError as exc:   # soft fail, as the reference does
                print(f"[roadvision] projector init failed: {exc}")

        self.sort_state = init_state(self.track_slots, self.device) \
            if self.track_enabled else None
        self._t0: Optional[float] = None

    # ------------------------------------------------------------------
    def _dets_tail(self, b: int, boxes, conf, cls_id, valid, ts):
        """Detections → (track ids, distance, speed), (B, max_det) each."""
        proj = self.projector.device_params() if self.projector else None
        max_det = boxes.shape[1]
        dev = boxes.device
        if self.track_enabled:
            outs = []
            for i in range(b):
                self.sort_state, o = self._sort_step(
                    self.sort_state, boxes[i], cls_id[i], conf[i], valid[i],
                    ts[i], proj)
                outs.append(o)
            return (torch.stack([o.track_id for o in outs]),
                    torch.stack([o.distance_m for o in outs]),
                    torch.stack([o.speed_kmh for o in outs]))
        ids = torch.zeros((b, max_det), dtype=torch.int32, device=dev)
        nan = torch.full((b, max_det), float("nan"), device=dev)
        if proj is not None:
            h_mat, origin, maxd = proj
            ground, gvalid = project_boxes_device(h_mat, boxes)
            return ids, distance_device(ground, gvalid & valid, origin,
                                        maxd), nan
        return ids, nan, nan.clone()

    def sampled_plans(self, h: int, w: int, want_proc: bool):
        """The letterbox's (stride, offset, count) sample grid per axis
        when the sampled preprocess path applies to (h, w) frames, else
        None: opted in, nothing reads the full processed frame, the
        chain can sample, and the resize is a pure slice on both axes."""
        det, pre = self.detector, self.pipeline
        if not self._sampled_pre or det is None or want_proc \
                or pre.identity or not pre.supports_sampled():
            return None
        r = min(det.imgsz / h, det.imgsz / w)
        new_h, new_w = round(h * r), round(w * r)
        py, px = axis_plan(h, new_h), axis_plan(w, new_w)
        if py[0] != "slice" or px[0] != "slice":
            return None
        return (py[1], py[2], new_h), (px[1], px[2], new_w)

    @torch.inference_mode()
    def step(self, frames_u8: torch.Tensor, ts: torch.Tensor,
             want_proc: bool = True):
        """The device step: (B, H, W, 3) uint8 + (B,) float32 stamps →
        (proc, (boxes, conf, cls, valid, ids, dist, speed)); ``proc`` is
        None on the sampled preprocess path."""
        b, h, w = frames_u8.shape[:3]
        plans = self.sampled_plans(h, w, want_proc)
        proc = None if plans is not None \
            else self.pipeline.apply_batch(frames_u8)
        det = self.detector
        if det is None:
            md = self.max_det
            z = torch.zeros((b, md), device=self.device)
            nan = torch.full((b, md), float("nan"), device=self.device)
            return proc, (torch.zeros((b, md, 4), device=self.device), z,
                          torch.zeros((b, md), dtype=torch.int32,
                                      device=self.device),
                          torch.zeros((b, md), dtype=torch.bool,
                                      device=self.device),
                          torch.zeros((b, md), dtype=torch.int32,
                                      device=self.device), nan, nan.clone())
        if plans is not None:
            small = torch.stack(
                self.pipeline.sampled_planes_fn(*plans)(frames_u8), dim=-1)
            imgs, ratio, pad = finish_letterbox(
                small, (h, w), size=det.imgsz, rect=det.rect)
        else:
            imgs, ratio, pad = det.letterbox(proc)
        boxes, conf, cls_id, valid = det.detect(imgs)
        boxes = scale_boxes(boxes, ratio, pad, (h, w))
        ids, dist, speed = self._dets_tail(b, boxes, conf, cls_id, valid, ts)
        return proc, (boxes, conf, cls_id, valid, ids, dist, speed)

    # ------------------------------------------------------------------
    def dispatch_batch(self, frames: np.ndarray, timestamps: np.ndarray,
                       want_proc: bool = True):
        """Queue one batch on the device; returns a handle for
        :meth:`collect_batch`. Timestamps are rebased to the stream start
        in float32, as the JAX engine does."""
        if self._t0 is None:
            self._t0 = float(timestamps[0])
        ts_rel = (np.asarray(timestamps) - self._t0).astype(np.float32)
        self.pipeline.ensure_gate_calibrated(frames)
        host = torch.from_numpy(np.ascontiguousarray(frames))
        if self.device.type == "cuda":
            host = host.pin_memory()
        dev = host.to(self.device, non_blocking=True)
        ts = torch.from_numpy(ts_rel).to(self.device, non_blocking=True)
        proc, arrays = self.step(dev, ts, want_proc)
        out = [proc if want_proc else None, *arrays]
        if self.device.type == "cuda":
            out = [None if t is None else t.to("cpu", non_blocking=True)
                   for t in out]
            done = torch.cuda.Event()
            done.record()
        else:
            done = None
        return frames, timestamps, out, done

    def collect_batch(self, inflight) -> List[FrameResult]:
        """Wait for an in-flight batch and unpack its results."""
        frames, timestamps, out, done = inflight
        if done is not None:
            done.synchronize()
        proc = None if out[0] is None else out[0].numpy()
        arrays = [t.numpy() for t in out[1:]]
        b = frames.shape[0]
        if self.detector is not None:
            names = [self.detector.names.get(i, str(i))
                     for i in range(self.detector.nc)]
        else:
            names = list(COCO_NAMES)
        per_frame = unpack_detections(arrays, names, b)
        return [FrameResult(frames[i],
                            proc[i] if proc is not None else frames[i],
                            per_frame[i], float(timestamps[i]))
                for i in range(b)]

    def process_batch(self, frames: np.ndarray, timestamps: np.ndarray,
                      want_proc: bool = True) -> List[FrameResult]:
        """(B, H, W, 3) BGR uint8 + (B,) float64 stamps → per-frame results."""
        return self.collect_batch(self.dispatch_batch(frames, timestamps,
                                                      want_proc))

    def stream(self, source, max_frames: Optional[int] = None,
               want_proc: bool = True) -> Iterator[FrameResult]:
        """Decode on a reader thread; two batches in flight on the card.
        A failure of the source ends the stream and is raised here."""
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()
        failed: List[BaseException] = []

        def reader():
            count = 0
            try:
                while not stop.is_set():
                    n = self.batch_size
                    if max_frames is not None:
                        n = min(n, max_frames - count)
                        if n <= 0:
                            break
                    frames, ts, m = source.read_batch(n)
                    if m == 0:
                        break
                    q.put((frames, ts))
                    count += m
            except Exception as exc:   # handed to the consuming thread
                failed.append(exc)
            finally:
                q.put(None)

        thread = threading.Thread(target=reader, daemon=True)
        thread.start()
        pending: list = []
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                pending.append(self.dispatch_batch(*item, want_proc=want_proc))
                if len(pending) >= 2:
                    yield from self.collect_batch(pending.pop(0))
            for inflight in pending:
                yield from self.collect_batch(inflight)
            if failed:
                raise RuntimeError("frame source failed") from failed[0]
        finally:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=2.0)

    def reset(self) -> None:
        if self.track_enabled:
            self.sort_state = init_state(self.track_slots, self.device)
        self._t0 = None
