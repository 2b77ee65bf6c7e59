"""Tracker registry — the port of ``roadvision_tpu/track/registry.py``.

Two factories, one per calling convention, dispatching on the same
``backend`` key so a config drives both paths identically:

  * :func:`build_tracker` — host-facing Tracker objects with the
    ``update(dets, ts, projector)`` list API;
  * :func:`build_device_step` — the single-frame tensor step the engine
    runs over a batch's frames; the re-id backends' step carries
    ``needs_embeddings = True``.

Backends: sort, bytetrack, ocsort, deepsort, strongsort (deepsort with
NSA on by default; the engine turns ``tracking.gmc`` on for it) and
botsort. An unknown name is a ``ValueError``.
"""
from __future__ import annotations

from typing import Any, Dict, Type

from ..utils.device import DeviceLike
from .base import Tracker
from .botsort import BotSortTracker, make_botsort_step
from .bytetrack import ByteTracker, make_byte_step
from .deepsort import DeepSortTracker, make_deepsort_step
from .ocsort import OcSortTracker, make_oc_step
from .sort import make_sort_step
from .sort_tracker import SortTracker

BACKENDS: Dict[str, Type[Tracker]] = {
    "sort": SortTracker,
    "bytetrack": ByteTracker,
    "ocsort": OcSortTracker,
    "deepsort": DeepSortTracker,
    "strongsort": DeepSortTracker,
    "botsort": BotSortTracker,
}


def _backend(cfg: Dict[str, Any]) -> str:
    name = str(cfg.get("backend") or "sort").lower()
    if name not in BACKENDS:
        raise ValueError(f"unknown tracking backend: {name}")
    return name


def build_tracker(cfg: Dict[str, Any], device: DeviceLike = None) -> Tracker:
    return BACKENDS[_backend(cfg)](cfg, device=device)


def build_device_step(cfg: Dict[str, Any]):
    """Single-frame tracking step from a ``tracking:`` config:
    ``step(state, boxes (D,4), cls (D,), conf (D,), dvalid (D,), ts (),
    proj, emb=None, shift=None) → (state', SortOutput)`` for every
    backend."""
    name = _backend(cfg)
    # NSA Kalman: measurement noise scaled by (1 - conf)
    nsa = bool(cfg.get("nsa", name == "strongsort"))
    staleness = float(cfg.get("max_staleness", 1.0))
    window = float(cfg.get("speed_window", 0.75))
    iou_t = float(cfg.get("iou_threshold", 0.3))
    byte = dict(
        track_high_thresh=float(cfg.get("track_high_thresh", 0.5)),
        track_low_thresh=float(cfg.get("track_low_thresh", 0.1)),
        new_track_thresh=float(cfg.get("new_track_thresh", 0.6)),
        match_iou=float(cfg.get("match_iou", iou_t)),
        second_match_iou=float(cfg.get("second_match_iou", 0.5)))
    app = dict(app_weight=float(cfg.get("app_weight", 0.5)),
               app_thresh=float(cfg.get("app_thresh", 0.6)),
               rescue_iou=float(cfg.get("rescue_iou", 0.02)))
    if name == "sort":
        return make_sort_step(
            iou_t, staleness, window, int(cfg.get("min_hits", 3)),
            association=str(cfg.get("association", "greedy")), nsa=nsa)
    if name == "bytetrack":
        return make_byte_step(staleness, window, nsa=nsa, **byte)
    if name == "ocsort":
        ocr = cfg.get("ocr_iou")
        return make_oc_step(
            iou_t, staleness, window,
            vdc_weight=float(cfg.get("vdc_weight", 0.2)),
            ocr_iou=float(ocr) if ocr is not None else iou_t,
            use_ocr=bool(cfg.get("use_ocr", True)),
            oru_steps=int(cfg.get("oru_steps", 4)),
            new_track_thresh=byte["new_track_thresh"], nsa=nsa)
    if name in ("deepsort", "strongsort"):
        step = make_deepsort_step(
            iou_t, staleness, window,
            new_track_thresh=byte["new_track_thresh"], nsa=nsa, **app)
    else:
        step = make_botsort_step(staleness, window, nsa=nsa, **byte, **app)
    step.needs_embeddings = True   # the engine computes descriptors
    return step
