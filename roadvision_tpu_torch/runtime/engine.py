"""Batched pipeline engine on the card — the port of
``roadvision_tpu/runtime/engine.py`` (the default realtime step).

One batch of BGR uint8 frames goes host → device once; on the device it
runs preprocess chain → letterbox → YOLOv8 forward → DFL decode → NMS →
box rescale → SORT over the batch's frames → geometry; the results come
back in one transfer. The track state stays on the device across
batches, in the same tensors: a step, :meth:`PipelineEngine.reset` and
:meth:`PipelineEngine.load_state` copy into them.

:meth:`PipelineEngine.build_raw_step` is that step as a pure function,
as in JAX. On the card it reads nothing back to the host for the
configurations :attr:`PipelineEngine.step_mode` names ``"graph"`` (the
main path and the fleet with every tracking backend, with or without
GMC, RT-DETR and the auto-gated chain, among others): the association
and NMS loops are CUDA kernels (K4–K6), so is RT-DETR's deformable
sampling (K7), every constant is uploaded once, and GMC's carried
thumbnail and its flag are tensors of the engine's state.
There :meth:`PipelineEngine.step_batch`, which ``dispatch_batch``,
``process_batch``, ``stream`` and the bench's device-resident loop run,
replays one CUDA graph per (shape, want_proc) (``runtime/graph.py``, the
counterpart of the JAX engine's ``jax.jit``). ``step_mode`` is
``"eager"`` on the CPU and wherever :attr:`PipelineEngine.eager_reason`
names what the step still does on the host; :meth:`PipelineEngine.step`
is always the eager step. :meth:`PipelineEngine.dispatch_batch` queues a batch without
waiting for its results; :meth:`PipelineEngine.stream` keeps two batches
in flight so the host's decode and unpack overlap the card's work.

Frames reach the card through :meth:`PipelineEngine.upload`: a ring of
pinned host buffers, each paired with a device buffer, copied on a CUDA
stream of its own. ``stream``'s reader thread starts the upload as soon
as a batch is decoded; the compute stream waits on the copy's event, and
a buffer is refilled only after the step that read it has finished.
Results come back into pinned buffers too, so the copy back overlaps the
next batch's work; ``collect_batch`` copies them out before the buffers
are used again.

Around the step, as in the JAX engine: ``timer`` (a ``StageTimer`` with
the stages ``decode``, ``upload``, ``dispatch`` and inside it ``stamps``,
``replay``, ``download``, then ``device_step`` (the host's wait for the
results, not device time) and ``host_unpack``; the spans of one batch
carry its sequence number), a
watchdog (``tpu.watchdog_s``: a diagnostic that sets ``watchdog_fired``
when a warmed-up shape's step runs longer, never an abort),
:meth:`PipelineEngine.save_state` / :meth:`PipelineEngine.load_state`
and :meth:`PipelineEngine.lb_meta`. On the card the step marks four
boundaries with the card's own timer (``utils/profiler.py::stage_mark``:
its start, preprocess done, the detector's pass done, its end) into
``stage_stamps``, which ride the copy back with the results;
``collect_batch`` records them as the device stages
``device.preprocess``, ``device.detector``, ``device.tracker`` and
``device.step`` of the timer.

With ``tpu.sampled_preprocess`` and ``want_proc=False``, where the
letterbox resize is an exact odd-stride slice on both axes (1080p → 640
is stride 3) and the chain has a sampled terminal op, the chain's last
op evaluates only the letterbox's sample grid and
:func:`finish_letterbox` pads the result: bit-equal detector input, no
full processed frame. An ``auto_gate.contrast_thresh: "auto"`` gate is
calibrated from the first batch, on the host, before that batch runs.

The detector's pass is ``YOLOTorch.run``: one letterboxed forward, the
three augmented ones (``detect.tta``), or the tiles of every frame in
one batch plus the full frames (``detect.tiling``); for the segment,
pose and obb tasks an 8th device output (masks at prototype resolution,
keypoints, rotated boxes) rides the copy back into ``Detection``. An
NMS-free detector (RT-DETR, ``RTDETRTorch.run``) stretches instead of
letterboxing and selects its top-k without NMS; the sampled preprocess
path does not apply to it and :meth:`PipelineEngine.lb_meta` is the
identity. With ``compute_dtype: int8`` and ``int8_calibration: N`` the
first N frames calibrate the static activation scales (the JAX engine
ignores that key; its ``YOLOJax.infer_batch`` reads it).

Tracking runs every backend of ``track/registry.py``. The re-id
backends (deepsort, strongsort, botsort) get per-detection descriptors
computed on the device from the RAW frames: the grid descriptor, or the
learned embedder when ``tracking.reid_weights`` names a usable file (an
unusable one is logged and the grid descriptor kept, as in JAX).
``tracking.gmc`` (on by default for strongsort) estimates each frame's
camera shift by phase correlation of gray thumbnails inside the step and
carries the last thumbnail across batches in the engine's own tensors
(``gmc_prev`` (G, G) and the flag ``gmc_valid`` (), 0 before the first
batch; ``gmc_prev`` in the state file).

``detect.temporal_gate`` (plain detect task, no tiling, not with GMC)
skips the detector on near-static scenes: the motion score of batch i,
read on the host when batch i is collected, decides whether a later
batch coasts (:meth:`PipelineEngine.build_coast_step`: preprocess and
the tracker tail on the last full batch's final-frame detections, kept
on the device); skips are counted at dispatch, at most
``max_skip_batches`` in a row; ``gate_frames_coasted`` counts the
coasted frames. :meth:`PipelineEngine.build_gated_scan_step` is the
bench's gate, deciding per batch on that batch's own score: torch has no
``lax.cond``, so it reads the one flag on the host (one sync a batch).

Config keys as in the JAX engine. A tracker or projector that fails to
build is logged ("tracker init failed", "projector init failed") and the
engine runs without it, as the JAX engine does; a failing frame source
ends :meth:`PipelineEngine.stream` with a log line.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from ..detect.types import COCO_NAMES, Detection
from ..geometry.projector import (HomographyProjector, build_projector,
                                  distance_device, project_boxes_device)
from ..ops.letterbox import axis_plan, finish_letterbox, letterbox_meta
from ..preprocess import PreprocessPipeline
from ..track.gmc import GMC_SIZE, batch_shifts, fresh_carry, gray_thumbnail
from ..track.registry import build_device_step
from ..track.sort import (SortState, init_state, read_flag, scan_steps,
                          state_from_jax)
from ..utils.device import DeviceLike, device_constant, resolve_device
from ..utils.logging import get_logger
from ..utils.profiler import STAGE_MARKS, device_stages, stage_mark
from ..utils.timing import StageTimer
from .graph import CapturedStep

log = get_logger("roadvision.engine")

# pinned/device buffer pairs for uploads: stream() can hold two batches
# dispatched, two queued and one being filled
UPLOAD_SLOTS = 5
GATE_BLOCK = 8   # motion-probe pooling block (thumbnail px per side)


class FrameResult(NamedTuple):
    raw: np.ndarray          # (H, W, 3) uint8 BGR
    proc: np.ndarray         # (H, W, 3) uint8 BGR
    detections: List[Detection]
    ts: float


def _motion_score(frames_u8: torch.Tensor, prev_thumb: torch.Tensor,
                  prev_valid: float):
    """Temporal-gate motion probe → (score (), last thumbnail (G, G)), as
    ``roadvision_tpu/runtime/engine.py::_motion_score``: the max over
    consecutive gray-thumbnail pairs (the carried previous thumbnail
    first, when ``prev_valid``) of the max GATE_BLOCK-blockwise mean abs
    difference, in u8 levels; +inf when no pair is observable."""
    g = gray_thumbnail(frames_u8)                      # (B, G, G)
    prev = torch.cat([prev_thumb[None], g[:-1]], dim=0)
    d = (g - prev).abs()
    nb = GMC_SIZE // GATE_BLOCK
    b = d.shape[0]
    blocks = d.reshape(b, nb, GATE_BLOCK, nb, GATE_BLOCK).mean(dim=(2, 4))
    per_pair = blocks.amax(dim=(1, 2))                 # (B,)
    inf = device_constant(float("inf"), torch.float32, g.device)
    first = per_pair[0] if prev_valid > 0 else -inf
    rest = per_pair[1:].max() if b > 1 else -inf
    score = torch.maximum(first, rest)
    return torch.where(torch.isinf(score), inf, score), g[-1]


def unpack_detections(arrays, names: List[str], b: int,
                      extra_field: Optional[str] = None
                      ) -> List[List[Detection]]:
    """Masked fixed-shape arrays (boxes, conf, cls, valid, ids, dist,
    speed[, extra]) → per-frame ``Detection`` lists. An 8th array is a
    task head's side output and fills the ``Detection`` field
    ``extra_field`` (the detector's ``extra_field``)."""
    boxes, conf, cls_id, valid, ids, dist, speed = arrays[:7]
    extra = extra_field if len(arrays) == 8 else None
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
            speed_kmh=vspeed[n] if speed_ok[n] else None,
            **({extra: arrays[7][i, sj[n]]} if extra else {})))
    return per_frame


class Upload(NamedTuple):
    """A batch on its way to the device: ``frames`` is the device tensor,
    valid on a stream once it has waited on ``ready`` (None on the CPU);
    ``slot`` is the ring slot to hand back, or None."""
    frames: torch.Tensor
    ready: Optional["torch.cuda.Event"]
    slot: Optional["_UploadSlot"]


class _UploadSlot:
    """One flat pinned host buffer and the device buffer it is copied to;
    a batch of fewer frames than the slot holds takes a contiguous prefix
    of both. ``uploaded`` is set while an upload waits to be dispatched;
    ``copied`` is the event after the last host→device copy, ``consumed``
    the event after the step that read the device buffer."""

    def __init__(self, numel, device):
        self.host = torch.empty(numel, dtype=torch.uint8, pin_memory=True)
        self.dev = torch.empty(numel, dtype=torch.uint8, device=device)
        self.uploaded = False
        self.copied: Optional[torch.cuda.Event] = None
        self.consumed: Optional[torch.cuda.Event] = None


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
        self.detector = None
        if det_cfg.get("enabled", False):
            from ..detect.registry import build_detector
            self.detector = build_detector(det_cfg, device=self.device,
                                           seed=seed)
        self.max_det = int(det_cfg.get("max_det", 100))
        slots = tpu_cfg.get("track_slots")
        self.track_slots = int(slots) if slots else max(64, self.max_det)
        if self.track_slots < self.max_det:
            log.warning(
                "tpu.track_slots=%d < detect.max_det=%d: more than %d "
                "concurrent new objects will drop tracks", self.track_slots,
                self.max_det, self.track_slots)

        track_cfg = cfg.get("tracking", {}) or {}
        self.track_enabled = bool(track_cfg.get("enabled", False)) \
            and self.detector is not None
        self._sort_step = None
        if self.track_enabled:
            try:
                self._sort_step = build_device_step(track_cfg)
            except NotImplementedError:
                raise      # a backend not ported yet says so by name
            except Exception as exc:   # soft fail, as the reference does
                log.warning("tracker init failed: %s", exc)
                self.track_enabled = False

        # per-detection descriptors for the re-id backends: the grid
        # descriptor, or the learned embedder from tracking.reid_weights
        self._embed_fn = None
        if getattr(self._sort_step, "needs_embeddings", False):
            from ..track.appearance import box_embeddings
            self._embed_fn = box_embeddings
            reid_w = track_cfg.get("reid_weights")
            if reid_w:
                try:
                    from ..track.reid import load_reid_params, make_reid_embed
                    self._embed_fn = make_reid_embed(
                        load_reid_params(reid_w, device=self.device))
                    log.info("re-id: learned embedder from %s", reid_w)
                except Exception as exc:  # soft fail, keep grid descriptor
                    log.warning("re-id weights %s unusable (%s); using "
                                "the grid descriptor", reid_w, exc)

        # camera-motion compensation: the previous batch's last thumbnail
        # and whether there is one, made once (a captured graph reads and
        # writes them)
        backend_name = str(track_cfg.get("backend") or "sort").lower()
        self.gmc_enabled = self.track_enabled \
            and bool(track_cfg.get("gmc", backend_name == "strongsort"))
        self.gmc_prev: Optional[torch.Tensor] = None
        self.gmc_valid: Optional[torch.Tensor] = None
        if self.gmc_enabled:
            self.gmc_prev, self.gmc_valid = fresh_carry((), self.device)

        # temporal gate: host policy with one batch of lag
        gcfg = (det_cfg.get("temporal_gate") or {}) \
            if self.detector is not None else {}
        self._gate_cfg: Optional[Dict[str, float]] = None
        if gcfg.get("enable"):
            if getattr(self.detector, "task", "detect") != "detect" \
                    or getattr(self.detector, "tile_cfg", None):
                raise ValueError(
                    "detect.temporal_gate supports the plain detect task "
                    "without tiling (coasting has no defined semantics "
                    "for masks/keypoints/rboxes or tiled candidates)")
            if self.gmc_enabled:
                raise ValueError(
                    "detect.temporal_gate and tracking.gmc are mutually "
                    "exclusive (camera motion raises the gate's motion "
                    "score, so the scene never qualifies as static)")
            self._gate_cfg = dict(
                thresh=float(gcfg.get("thresh", 1.5)),
                max_skip=int(gcfg.get("max_skip_batches", 3)))
        self._gate_score: Optional[float] = None
        self._gate_skips = 0
        self._gate_dets = None          # device (boxes, conf, cls, valid)
        self._gate_thumb: Optional[torch.Tensor] = None
        self.gate_frames_coasted = 0

        geom_cfg = cfg.get("geometry", {}) or {}
        self.projector: Optional[HomographyProjector] = None
        if geom_cfg.get("enabled", False):
            try:
                self.projector = build_projector(geom_cfg, device=self.device)
            except NotImplementedError:
                raise
            except Exception as exc:   # soft fail, as the reference does
                log.warning("projector init failed: %s", exc)

        self.sort_state = init_state(self.track_slots, self.device) \
            if self.track_enabled else None
        # what a step reads and writes, bound once (a captured graph's
        # state is this object)
        self._step_state = (*self.sort_state, self.gmc_prev,
                            self.gmc_valid) if self.gmc_enabled \
            else self.sort_state
        self._t0: Optional[float] = None
        self.timer = StageTimer()
        self._batches = 0
        # the step's stage marks (a captured graph writes them on every
        # replay; each batch's copy back takes them along)
        self.stage_stamps = torch.zeros(
            STAGE_MARKS, dtype=torch.int64, device=self.device) \
            if self.device.type == "cuda" else None

        # device-step watchdog: a step that blocks far beyond the steady
        # rate usually means the card or its runtime stalled. Warn, never
        # kill, and skip the first call per shape (that one builds the
        # kernels and tunes the convolutions). 0 disables.
        self._watchdog_s = float(tpu_cfg.get("watchdog_s", 60.0))
        self._warmed: set = set()
        self.watchdog_fired = threading.Event()

        self._upload_lock = threading.Lock()
        self._upload_ring: List[_UploadSlot] = []
        self._upload_key: Optional[tuple] = None
        self._upload_next = 0
        self._upload_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._result_free: Dict[tuple, List[List[torch.Tensor]]] = {}

        # the captured steps, one per (frame shape, want_proc), and the
        # auto-gate's calibration epoch they were captured in
        self._graphs: Dict[tuple, CapturedStep] = {}
        self._graphs_epoch = self.pipeline.gate_epoch
        self.eager_reason = self._eager_reason()
        self.step_mode = "graph" if self.eager_reason is None else "eager"

    def _eager_reason(self) -> Optional[str]:
        """Why :meth:`step_batch` runs this configuration eagerly, from
        the configuration alone (None: it replays a CUDA graph). What is
        named either reads the host inside the step or has not been
        captured yet (ROADMAP)."""
        det = self.detector
        if self.device.type != "cuda":
            return "the CPU runs the plain path"
        if self._gate_cfg is not None:
            return ("detect.temporal_gate: the coast decision is read on "
                    "the host")
        if det is not None:
            from ..detect.rtdetr_torch import RTDETRTorch
            from ..detect.yolo_torch import YOLOTorch
            if isinstance(det, RTDETRTorch):
                if det.int8:
                    return ("the RTDETRTorch detector in int8: its "
                            "calibration_step keeps host state, not "
                            "captured")
            elif not isinstance(det, YOLOTorch):
                return f"the {type(det).__name__} detector: not captured"
            elif det.task != "detect" or det.tta or det.tile_cfg \
                    or det.int8:
                return ("task heads, TTA, tiling and int8 detectors: not "
                        "captured")
        return None

    def _store_state(self, state: Optional[SortState]) -> None:
        """The track state after a step, copied into the engine's own
        tensors (a captured graph reads and writes those); none without
        a tracker."""
        if self.sort_state is None:
            return
        with torch.inference_mode():
            for dst, src in zip(self.sort_state, state):
                if src is not dst:
                    dst.copy_(src)

    def _store_gmc(self, last_gray: Optional[torch.Tensor]) -> None:
        """GMC's carry after a step (the batch's last thumbnail; the flag
        set), or before the first batch (None: zeros, flag 0), copied
        into the engine's own tensors."""
        with torch.inference_mode():
            if last_gray is None:
                self.gmc_prev.zero_()
                self.gmc_valid.zero_()
            else:
                if last_gray is not self.gmc_prev:
                    self.gmc_prev.copy_(last_gray)
                self.gmc_valid.fill_(1.0)

    def step_state(self):
        """The tensors a step of this engine reads and writes: the track
        state (a ``SortState``, None without a tracker) or, with GMC, its
        fields followed by ``gmc_prev`` and ``gmc_valid``; the same object
        on every call."""
        return self._step_state

    def with_gmc_carry(self, raw):
        """A raw step ``raw(state, frames, ts, gmc_prev=None,
        gmc_valid=None)`` (:meth:`build_raw_step`, the fleet's
        ``make_stream_step``) as ``fn(state, frames, ts) → (outputs,
        state')`` over :meth:`step_state`'s layout: with GMC the carry is
        read from the state's last two tensors and written back there (the
        batch's last thumbnail, the flag set to 1)."""
        if not self.gmc_enabled:
            def fn(state, frames, ts):
                *outs, state = raw(state, frames, ts)
                return tuple(outs), state
            return fn
        n = len(SortState._fields)

        def fn(state, frames, ts):
            *outs, sort_state, last = raw(SortState(*state[:n]), frames, ts,
                                          *state[n:])
            return tuple(outs), (*sort_state, last,
                                 torch.ones_like(state[-1]))
        return fn

    # ------------------------------------------------------------------
    def _tail(self, state: Optional[SortState], b: int, boxes, conf, cls_id,
              valid, ts, frames_u8: Optional[torch.Tensor] = None,
              shifts: Optional[torch.Tensor] = None):
        """Detections → (state', track ids, distance, speed), (B, max_det)
        each: the tracker step scanned over the batch's frames from
        ``state`` (None without a tracker; ``track/sort.py::scan_steps``).
        A stacked state (a fleet's S streams, any backend) takes (S, B,
        ...) detections, frames and shifts and (S, B) stamps and gives
        (S, B, max_det) arrays. ``frames_u8`` are the RAW frames the re-id
        backends' descriptors are computed from; ``shifts`` (B, 2) the GMC
        camera shifts in source px."""
        proj = self.projector.device_params() if self.projector else None
        lead = boxes.shape[:-1]
        dev = boxes.device
        if self.track_enabled:
            emb = self._embed_fn(frames_u8, boxes, valid) \
                if self._embed_fn is not None else None
            state, out = scan_steps(self._sort_step, state, boxes, cls_id,
                                    conf, valid, ts, proj, emb, shifts)
            return state, out.track_id, out.distance_m, out.speed_kmh
        ids = torch.zeros(lead, dtype=torch.int32, device=dev)
        nan = torch.full(lead, float("nan"), device=dev)
        if proj is not None:
            h_mat, origin, maxd = proj
            ground, gvalid = project_boxes_device(h_mat, boxes)
            return state, ids, distance_device(ground, gvalid & valid,
                                               origin, maxd), nan
        return state, ids, nan, nan.clone()

    def _dets_tail(self, b: int, boxes, conf, cls_id, valid, ts,
                   frames_u8: Optional[torch.Tensor] = None,
                   shifts: Optional[torch.Tensor] = None):
        """:meth:`_tail` on the engine's own track state: detections →
        (track ids, distance, speed)."""
        state, ids, dist, speed = self._tail(
            self.sort_state, b, boxes, conf, cls_id, valid, ts, frames_u8,
            shifts)
        self._store_state(state)
        return ids, dist, speed

    def _shifts(self, frames_u8: torch.Tensor, prev: torch.Tensor,
                valid: torch.Tensor):
        """GMC on the device: per-frame camera shifts (..., B, 2) in
        source px of (..., B, H, W, 3) frames against the carried
        thumbnail ``prev`` (..., G, G) (the first frame's forced to 0 where
        the flag ``valid`` () is 0), and the batch's last thumbnail (...,
        G, G), to carry on."""
        h, w = frames_u8.shape[-3:-1]
        grays = gray_thumbnail(frames_u8)
        shifts = batch_shifts(prev, grays, valid,
                              (max(1, w // GMC_SIZE), max(1, h // GMC_SIZE)))
        return shifts, grays[..., -1, :, :]

    def sampled_plans(self, h: int, w: int, want_proc: bool):
        """The letterbox's (stride, offset, count) sample grid per axis
        when the sampled preprocess path applies to (h, w) frames, else
        None: opted in, nothing reads the full processed frame, the
        chain can sample, and the resize is a pure slice on both axes."""
        det, pre = self.detector, self.pipeline
        if not self._sampled_pre or det is None or want_proc \
                or det.tile_cfg or getattr(det, "nms_free", False) \
                or pre.identity or not pre.supports_sampled():
            return None
        r = min(det.imgsz / h, det.imgsz / w)
        new_h, new_w = round(h * r), round(w * r)
        py, px = axis_plan(h, new_h), axis_plan(w, new_w)
        if py[0] != "slice" or px[0] != "slice":
            return None
        return (py[1], py[2], new_h), (px[1], px[2], new_w)

    def empty_outs(self, b: int):
        """The 7 per-frame arrays of a batch without detections."""
        md, dev = self.max_det, self.device
        nan = torch.full((b, md), float("nan"), device=dev)
        return (torch.zeros((b, md, 4), device=dev),
                torch.zeros((b, md), device=dev),
                torch.zeros((b, md), dtype=torch.int32, device=dev),
                torch.zeros((b, md), dtype=torch.bool, device=dev),
                torch.zeros((b, md), dtype=torch.int32, device=dev),
                nan, nan.clone())

    def mark(self, slot: int) -> None:
        """Stage mark ``slot`` of the step into :attr:`stage_stamps` (none
        on the CPU)."""
        stage_mark(self.stage_stamps, slot)

    def front(self, frames_u8: torch.Tensor, want_proc: bool = True):
        """Preprocess and the detector's whole pass over (N, H, W, 3)
        uint8 frames → (proc, (boxes, conf, cls, valid, extra)); ``proc``
        is None on the sampled preprocess path, the detections None
        without a detector. Marks 1 and 2 fall after preprocess (the
        sampled path's letterbox included) and after the detector's
        pass."""
        n, h, w = frames_u8.shape[:3]
        plans = self.sampled_plans(h, w, want_proc)
        proc = None if plans is not None \
            else self.pipeline.apply_batch(frames_u8)
        det = self.detector
        if det is None:
            self.mark(1)
            self.mark(2)
            return proc, None
        lb = None
        if plans is not None:
            small = torch.stack(
                self.pipeline.sampled_planes_fn(*plans)(frames_u8), dim=-1)
            lb = finish_letterbox(small, (h, w), size=det.imgsz,
                                  rect=det.rect)
        self.mark(1)
        # the detector's whole pass: plain, TTA, tiled, or a task head
        # with its side output (masks, keypoints or rboxes) as ``extra``
        dets = det.run(frames_u8 if proc is None else proc, lb)
        self.mark(2)
        return proc, dets

    def build_raw_step(self, shape, want_proc: bool = True):
        """The pure device step for (B, H, W) batches — the JAX engine's
        ``build_raw_step`` (:374) without ``params`` (the port's detector
        owns its weights): ``step(sort_state, frames_u8 (B, H, W, 3) u8,
        ts (B,) f32, gmc_prev=None, gmc_valid=None) → (proc, outs,
        sort_state')``, with outs the 7 arrays (8 with a task head) and
        ``proc`` None on the sampled preprocess path. Preprocess, the
        detector's pass with its NMS, then the tracker tail as one scan
        over the batch's frames (``make_sort_scan``'s loop over the
        registry's step). With GMC's carry, the thumbnail ``gmc_prev``
        (G, G) and its flag ``gmc_valid`` () (0: no previous batch), the
        step computes the camera shifts itself and returns the batch's
        last thumbnail after the state: → (proc, outs, sort_state',
        last_gray), as JAX's does. Nothing it is given is written but
        :attr:`stage_stamps` (its four marks, on the card)."""
        b = shape[0]

        def step(sort_state, frames_u8, ts, gmc_prev=None, gmc_valid=None):
            self.mark(0)
            proc, dets = self.front(frames_u8, want_proc)
            if dets is None:
                self.mark(3)
                return proc, self.empty_outs(b), sort_state
            boxes, conf, cls_id, valid, extra = dets
            shifts = last = None
            if gmc_prev is not None and self.track_enabled:
                shifts, last = self._shifts(frames_u8, gmc_prev, gmc_valid)
            sort_state, ids, dist, speed = self._tail(
                sort_state, b, boxes, conf, cls_id, valid, ts, frames_u8,
                shifts)
            outs = (boxes, conf, cls_id, valid, ids, dist, speed)
            if extra is not None:
                outs = outs + (extra,)
            self.mark(3)
            if last is not None:
                return proc, outs, sort_state, last
            return proc, outs, sort_state

        return step

    @torch.inference_mode()
    def step(self, frames_u8: torch.Tensor, ts: torch.Tensor,
             want_proc: bool = True):
        """The eager device step on the engine's track state (and GMC's
        carry): (B, H, W, 3) uint8 + (B,) float32 stamps → (proc, (boxes,
        conf, cls, valid, ids, dist, speed)); ``proc`` is None on the
        sampled preprocess path."""
        raw = self.build_raw_step(tuple(frames_u8.shape[:3]), want_proc)
        if self.gmc_enabled:
            proc, outs, state, last = raw(self.sort_state, frames_u8, ts,
                                          self.gmc_prev, self.gmc_valid)
            self._store_gmc(last)
        else:
            proc, outs, state = raw(self.sort_state, frames_u8, ts)
        self._store_state(state)
        return proc, outs

    def step_batch(self, frames_u8: torch.Tensor, ts: torch.Tensor,
                   want_proc: bool = True):
        """The step as the engine runs a batch: with ``step_mode ==
        "graph"`` the replay of the shape's captured graph (captured at
        the shape's first batch; the returned tensors are the graph's
        and hold until its next replay; the track state and GMC's carry
        are the graph's state), else :meth:`step`."""
        if self.step_mode != "graph":
            return self.step(frames_u8, ts, want_proc)
        # an "auto" gate threshold is resolved before the capture: the
        # graph holds it as a number
        self.pipeline.ensure_gate_calibrated(frames_u8)
        fn = self.with_gmc_carry(
            self.build_raw_step(tuple(frames_u8.shape[:3]), want_proc))
        return self.run_step((tuple(frames_u8.shape), want_proc), fn,
                             self.step_state(), (frames_u8, ts))[0]

    def run_step(self, key, fn, state, args):
        """``fn(state, *args) → (outputs, state')`` as this engine runs
        its steps: called, or with ``step_mode == "graph"`` the replay of
        the graph captured for ``key`` at its first call. A graph writes
        ``state'`` into the tensors of the ``state`` it was captured on
        (the same object on every call), which come back as ``state'``;
        its outputs hold until its next replay. A
        recalibrated auto-gate (``pipeline.gate_epoch`` moved) drops every
        captured graph: each holds its threshold."""
        if self.step_mode != "graph":
            return fn(state, *args)
        if self.pipeline.gate_epoch != self._graphs_epoch:
            self._graphs.clear()
            self._graphs_epoch = self.pipeline.gate_epoch
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = CapturedStep(fn, state, args)
            # a capture whose warm-up calibrated the gate holds the new
            # threshold
            self._graphs_epoch = self.pipeline.gate_epoch
        elif graph.state is not state:
            raise ValueError(f"the graph of {key} was captured on another "
                             f"state")
        return graph(*args), state

    # ------------------------------------------------------------------
    # temporal gating (detect.temporal_gate)
    def build_coast_step(self, shape, want_proc: bool = True):
        """The gated step: preprocess runs (display and recording need
        it), the detector is SKIPPED, and the tracker tail runs on one
        reused (max_det,) detection set replicated over the batch's
        frames; timestamps advance, so speeds decay toward zero.
        ``step(frames_u8, ts, boxes1, conf1, cls1, valid1, prev_thumb,
        prev_valid) → (proc, outs, (score, thumb))``."""
        b = shape[0]

        @torch.inference_mode()
        def step(frames_u8, ts, boxes1, conf1, cls1, valid1, prev_thumb,
                 prev_valid):
            proc = self.pipeline.apply_batch(frames_u8)
            dets = tuple(t[None].expand(b, *t.shape)
                         for t in (boxes1, conf1, cls1, valid1))
            ids, dist, speed = self._dets_tail(b, *dets, ts, frames_u8)
            return (proc if want_proc else None, dets + (ids, dist, speed),
                    _motion_score(frames_u8, prev_thumb, prev_valid))

        return step

    def build_gated_scan_step(self, shape):
        """The bench's temporal gate: each batch's own score against the
        carried thumbnail decides whether THIS batch coasts (on the last
        full batch's final-frame detections) or runs the detector. JAX
        branches inside the compiled step (``lax.cond``); here the one
        ``coast`` flag is read on the host, one sync a batch.

        Returns ``(step, init_carry)``: ``step(carry, frames_u8, ts) ->
        (outs, coasted, carry)`` with outs the 7 arrays of
        :meth:`step`; the carry holds (sort_state, thumb, thumb_valid,
        skips, gate_dets, gate_valid)."""
        if self._gate_cfg is None:
            raise ValueError("detect.temporal_gate is not enabled")
        b = shape[0]
        det = self.detector
        thresh = self._gate_cfg["thresh"]
        max_skip = self._gate_cfg["max_skip"]
        dev = self.device

        def init_carry():
            gdets = (torch.zeros((det.max_det, 4), device=dev),
                     torch.zeros((det.max_det,), device=dev),
                     torch.zeros((det.max_det,), dtype=torch.int32,
                                 device=dev),
                     torch.zeros((det.max_det,), dtype=torch.bool,
                                 device=dev))
            state = self.sort_state if self.sort_state is not None \
                else init_state(self.track_slots, dev)
            return (state, torch.zeros((GMC_SIZE, GMC_SIZE), device=dev),
                    0.0, 0, gdets, False)

        @torch.inference_mode()
        def step(carry, frames_u8, ts):
            sort_state, prev_thumb, prev_valid, skips, gdets, gvalid = carry
            score, last_thumb = _motion_score(frames_u8, prev_thumb,
                                              prev_valid)
            proc = self.pipeline.apply_batch(frames_u8)
            coast = gvalid and skips < max_skip \
                and read_flag(score < thresh)
            if coast:
                dets = tuple(g[None].expand(b, *g.shape) for g in gdets)
                skips += 1
            else:
                boxes, conf, cls_id, valid, _ = det.run(proc)
                dets = (boxes, conf, cls_id, valid)
                gdets = tuple(a[-1] for a in dets)
                skips = 0
            sort_state, ids, dist, speed = self._tail(sort_state, b, *dets,
                                                      ts, frames_u8)
            return dets + (ids, dist, speed), coast, \
                (sort_state, last_thumb, 1.0, skips, gdets,
                 gvalid or not coast)

        return step, init_carry

    def lb_meta(self, h: int, w: int):
        """(ratio, (left, top)) the device step letterboxes (h, w) frames
        with, computed on the host; the identity for a stretch-resize
        detector (RT-DETR), None when no detector is configured."""
        if self.detector is None:
            return None
        if getattr(self.detector, "nms_free", False):
            return 1.0, (0.0, 0.0)
        return letterbox_meta(h, w, size=self.detector.imgsz,
                              rect=self.detector.rect)

    # ------------------------------------------------------------------
    def upload(self, frames: np.ndarray) -> Upload:
        """Start the host→device copy of a (B, H, W, 3) uint8 batch — or
        a fleet's (S, B, H, W, 3) — and return at once. On the card the
        frames go through the next slot of the pinned ring, on the
        engine's upload stream; the call blocks only while that slot's
        previous batch is still being computed on. The ring's slots hold
        up to ``tpu.batch_size`` frames a stream (more when a batch is
        larger), so a clip's short last batch fits the slots of the full
        ones; they are made anew when any other dimension changes. Safe to
        call from a thread other than the one that dispatches."""
        frames = np.ascontiguousarray(frames)
        if self.device.type != "cuda":
            return Upload(torch.from_numpy(frames), None, None)
        axis = frames.ndim - 4                  # the batch (time) axis
        b = frames.shape[axis]
        key = frames.shape[:axis] + frames.shape[axis + 1:]
        with self._upload_lock, self.timer.stage("upload"):
            ring = self._upload_ring
            if not ring or self._upload_key != key \
                    or ring[0].host.numel() < frames.size:
                torch.cuda.synchronize(self.device)
                if any(s.uploaded for s in ring):
                    raise RuntimeError("frame shape changed while uploads "
                                       "were waiting to be dispatched")
                numel = frames.size // b * max(b, self.batch_size)
                ring[:] = [_UploadSlot(numel, self.device)
                           for _ in range(UPLOAD_SLOTS)]
                self._upload_key = key
                self._upload_next = 0
            slot = ring[self._upload_next]
            if slot.uploaded:
                raise RuntimeError(
                    f"{UPLOAD_SLOTS} uploads are waiting to be dispatched; "
                    f"dispatch one before uploading another")
            self._upload_next = (self._upload_next + 1) % len(ring)
            for event in (slot.copied, slot.consumed):
                if event is not None:
                    event.synchronize()
            slot.consumed = None
            slot.uploaded = True
            host = slot.host[:frames.size].view(frames.shape)
            dev = slot.dev[:frames.size].view(frames.shape)
            host.copy_(torch.from_numpy(frames))
            ready = torch.cuda.Event()
            with torch.cuda.stream(self._upload_stream):
                dev.copy_(host, non_blocking=True)
                ready.record()
            slot.copied = ready
            return Upload(dev, ready, slot)

    def download(self, out: List[Optional[torch.Tensor]]):
        """Queue the copy of device tensors (None entries pass through)
        into pinned host buffers, taken from a free list by shape and
        grown on demand, and record the event after it. Returns (host
        tensors, key, event); after ``event.synchronize()`` and once the
        values are copied out, :meth:`recycle` hands the buffers back."""
        key = tuple((tuple(t.shape), t.dtype) if t is not None else None
                    for t in out)
        free = self._result_free.setdefault(key, [])
        bufs = free.pop() if free else [
            None if t is None else
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in out]
        for dst, src in zip(bufs, out):
            if dst is not None:
                dst.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return bufs, key, done

    def recycle(self, key, bufs) -> None:
        """Return :meth:`download`'s buffers to the free list."""
        self._result_free[key].append(bufs)

    def dispatch_batch(self, frames: np.ndarray, timestamps: np.ndarray,
                       want_proc: bool = True,
                       device_frames: Optional[Upload] = None):
        """Queue one batch on the device; returns a handle for
        :meth:`collect_batch`. ``device_frames`` is what :meth:`upload`
        returned for these frames, when a reader thread started the copy
        early. Timestamps are rebased to the stream start in float32, as
        the JAX engine does."""
        seq = self._batches
        self._batches += 1
        with self.timer.stage("dispatch", seq):
            return self._dispatch(seq, frames, timestamps, want_proc,
                                  device_frames)

    def _dispatch(self, seq, frames, timestamps, want_proc, device_frames):
        timer = self.timer
        self.pipeline.ensure_gate_calibrated(frames)
        up = device_frames if device_frames is not None \
            else self.upload(frames)
        with timer.stage("stamps", seq):
            if self._t0 is None:
                self._t0 = float(timestamps[0])
            ts_rel = (np.asarray(timestamps) - self._t0).astype(np.float32)
            ts = torch.from_numpy(ts_rel).to(self.device, non_blocking=True)
        if up.ready is not None:
            torch.cuda.current_stream(self.device).wait_event(up.ready)
        with timer.stage("replay", seq):
            proc, arrays, score, coasted = self._run_batch(
                frames, up, ts, want_proc)
        # the gate's score and the step's marks ride the copy back, read
        # at collect time (the gated steps leave no marks)
        stamps = self.stage_stamps if self._gate_cfg is None else None
        out = [proc if want_proc else None, *arrays, stamps] \
            + ([] if score is None else [score])
        key, done = None, None
        with timer.stage("download", seq):
            if self.device.type == "cuda":
                out, key, done = self.download(out)
        if up.slot is not None:
            # after the copy back too: with no preprocessing the
            # processed frames are the slot's own buffer
            up.slot.consumed, up.slot.uploaded = done, False
        shape_key = (tuple(frames.shape[:3]), want_proc, coasted)
        return (frames, timestamps, out, done, key, shape_key,
                score is not None, seq)

    def _run_batch(self, frames, up, ts, want_proc):
        """The batch's step: the gate's coast or full step, or
        :meth:`step_batch` → (proc, arrays, gate score or None,
        coasted)."""
        gate = self._gate_cfg
        coasted = gate is not None \
            and self._gate_score is not None \
            and self._gate_score < gate["thresh"] \
            and self._gate_skips < gate["max_skip"] \
            and self._gate_dets is not None
        score = None
        if gate is not None:
            prev = self._gate_thumb if self._gate_thumb is not None \
                else torch.zeros((GMC_SIZE, GMC_SIZE), device=self.device)
            pvalid = 0.0 if self._gate_thumb is None else 1.0
            b = frames.shape[0]
            if coasted:
                proc, arrays, (score, self._gate_thumb) = \
                    self.build_coast_step((b,), want_proc)(
                        up.frames, ts, *self._gate_dets, prev, pvalid)
                # skips are counted at dispatch: counted at collect they
                # would lag a batch in the stream and overshoot the budget
                self._gate_skips += 1
                self.gate_frames_coasted += b
            else:
                proc, arrays = self.step(up.frames, ts, want_proc)
                with torch.inference_mode():
                    score, self._gate_thumb = _motion_score(up.frames, prev,
                                                            pvalid)
                self._gate_skips = 0
                # the reusable set: the final frame's detections, kept on
                # the device
                self._gate_dets = tuple(a[b - 1] for a in arrays[:4])
        else:
            proc, arrays = self.step_batch(up.frames, ts, want_proc)
        return proc, arrays, score, coasted

    def collect_batch(self, inflight) -> List[FrameResult]:
        """Wait for an in-flight batch and unpack its results; on the
        card, record the step's device stages from its marks."""
        frames, timestamps, out, done, key, shape_key, has_score, seq = \
            inflight
        dog = None
        if self._watchdog_s > 0 and shape_key in self._warmed:
            def bark():
                self.watchdog_fired.set()
                log.warning(
                    "device step has run > %.0fs for batch shape %s — the "
                    "card may be stalled (the step continues; this is a "
                    "diagnostic, not an abort)", self._watchdog_s,
                    shape_key[0])
            dog = threading.Timer(self._watchdog_s, bark)
            dog.daemon = True
            dog.start()
        try:
            with self.timer.stage("device_step", seq):
                if done is not None:
                    done.synchronize()
        finally:
            if dog is not None:
                dog.cancel()
            self._warmed.add(shape_key)
        with self.timer.stage("host_unpack", seq):
            if done is not None:
                # the pinned buffers go back to the free list: copy out
                host = [None if t is None else t.numpy().copy() for t in out]
                self.recycle(key, out)
            else:
                host = [None if t is None else t.numpy() for t in out]
            if has_score:
                # the score of THIS batch gates a later dispatch
                self._gate_score = float(host.pop())
            stamps = host.pop()
            proc, arrays = host[0], host[1:]
            b = frames.shape[0]
            if self.detector is not None:
                names = [self.detector.names.get(i, str(i))
                         for i in range(self.detector.nc)]
            else:
                names = list(COCO_NAMES)
            per_frame = unpack_detections(
                arrays, names, b,
                extra_field=getattr(self.detector, "extra_field", None))
            results = [FrameResult(frames[i],
                                   proc[i] if proc is not None else frames[i],
                                   per_frame[i], float(timestamps[i]))
                       for i in range(b)]
        if stamps is not None:
            for name, seconds in device_stages(stamps):
                self.timer.add(name, seconds, seq)
        return results

    def process_batch(self, frames: np.ndarray, timestamps: np.ndarray,
                      want_proc: bool = True,
                      device_frames: Optional[Upload] = None
                      ) -> List[FrameResult]:
        """(B, H, W, 3) BGR uint8 + (B,) float64 stamps → per-frame results."""
        return self.collect_batch(self.dispatch_batch(
            frames, timestamps, want_proc=want_proc,
            device_frames=device_frames))

    def stream(self, source, max_frames: Optional[int] = None,
               want_proc: bool = True) -> Iterator[FrameResult]:
        """Decode on a reader thread, which also starts each batch's
        upload; two batches in flight on the card. A failure of the
        source is logged and ends the stream, as in the JAX engine: the
        batches read before it are still yielded. A failure of the
        upload is the engine's own and is raised here."""
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
                    try:
                        with self.timer.stage("decode"):
                            frames, ts, m = source.read_batch(n)
                    except Exception as exc:   # a decode failure ends
                        log.warning("frame source failed: %s", exc)
                        break                  # the stream
                    if m == 0:
                        break
                    # the copy runs on the upload stream and overlaps
                    # the compute of the batches in flight
                    q.put((frames, ts, self.upload(frames)))
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
                frames, ts, up = item
                pending.append(self.dispatch_batch(
                    frames, ts, want_proc=want_proc, device_frames=up))
                if len(pending) >= 2:
                    yield from self.collect_batch(pending.pop(0))
            while pending:
                yield from self.collect_batch(pending.pop(0))
            if failed:
                raise failed[0]
        finally:
            stop.set()
            for inflight in pending:    # abandoned: hand the buffers back
                if inflight[3] is not None:
                    inflight[3].synchronize()
                    self.recycle(inflight[4], inflight[2])
            # empty the queue until the reader has ended (it may be
            # blocked in put); uploads nobody will dispatch free their slot
            deadline = time.monotonic() + 4.0
            while (thread.is_alive() or not q.empty()) \
                    and time.monotonic() < deadline:
                try:
                    item = q.get(timeout=0.05)
                except queue.Empty:
                    continue
                if item is not None and item[2].slot is not None:
                    item[2].slot.uploaded = False
            thread.join(timeout=0.1)

    def reset(self) -> None:
        if self.track_enabled:
            self._store_state(init_state(self.track_slots, self.device))
        if self.gmc_enabled:
            self._store_gmc(None)
        self._t0 = None
        # a new stream neither coasts on the last stream's detections or
        # score nor counts its coasted frames
        self._gate_score = None
        self._gate_skips = 0
        self._gate_dets = None
        self._gate_thumb = None
        self.gate_frames_coasted = 0

    def save_state(self, path) -> None:
        """Checkpoint the device-resident stream state (the whole
        ``SortState``, the GMC thumbnail when GMC is on and a batch has
        set it, and the stream's timestamp epoch) as an ``.npz`` with the JAX
        engine's key names (``sort_<field>`` for all 25 fields, ``gmc_prev``,
        ``t0``), so a long-running deployment can stop and resume exactly, in
        this package or in the JAX one. A file saved on the card loads on the
        CPU path, and the other way round."""
        data = {}
        if self.sort_state is not None:
            for k, v in zip(SortState._fields, self.sort_state):
                data[f"sort_{k}"] = v.cpu().numpy()
        data["t0"] = np.asarray(
            np.nan if self._t0 is None else self._t0, np.float64)
        if self.gmc_enabled and float(self.gmc_valid) == 1.0:
            data["gmc_prev"] = self.gmc_prev.cpu().numpy()
        np.savez(path, **data)

    def load_state(self, path) -> None:
        """Restore a :meth:`save_state` checkpoint, or one the JAX engine
        saved. The tracker slot count must match the current config; a
        file that lacks a tracker field is a ``ValueError`` naming it.
        Everything is copied into the engine's own tensors; with GMC on, a
        file's ``gmc_prev`` is a previous batch (flag 1), none is none."""
        with np.load(path) as z:
            if self.sort_state is not None:
                missing = [k for k in SortState._fields
                           if f"sort_{k}" not in z.files]
                if missing:
                    raise ValueError(
                        f"state file {path}: missing tracker arrays "
                        f"{missing} (saved without tracking?)")
                saved_slots = z["sort_alive"].shape[0]
                if saved_slots != self.track_slots:
                    raise ValueError(
                        f"state file {path}: {saved_slots} track slots, "
                        f"engine has {self.track_slots} "
                        f"(tpu.track_slots must match)")
                self._store_state(state_from_jax(
                    {k: z[f"sort_{k}"] for k in SortState._fields},
                    device=self.device))
            t0 = float(z["t0"])
            self._t0 = None if np.isnan(t0) else t0
            if self.gmc_enabled:
                # a thumbnail in the file is a previous batch (flag 1)
                self._store_gmc(torch.from_numpy(z["gmc_prev"]).to(
                    self.device) if "gmc_prev" in z.files else None)
