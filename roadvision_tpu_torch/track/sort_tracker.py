"""Host-facing SORT tracker with the list-of-Detection API — the port of
``roadvision_tpu/track/sort_tracker.py``.

Wraps the tensor step (``sort.py``) behind ``update(detections,
timestamp, projector=None) -> List[Detection]``. Config keys and
defaults as in the JAX package: max_staleness=1.0, min_hits=3,
iou_threshold=0.3, speed_window=0.75, plus ``det_capacity`` (default
100 == detect.max_det), ``track_slots`` (default max(64, det_capacity))
and ``nsa``.

Timestamps are rebased to the first-seen time before they reach the
device (float32 cannot hold unix epochs).
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch

from ..detect.types import Detection
from ..geometry import HomographyProjector
from ..utils.device import DeviceLike, resolve_device
from .base import Tracker
from .sort import SortState, init_state, make_sort_step


def parse_common_cfg(tracker, cfg: dict) -> None:
    """Shared host-Tracker config parsing: sets max_staleness / min_hits /
    iou_threshold / speed_window / det_capacity / track_slots (with the
    under-provisioned warning) and ``nsa`` with the same default rule as
    ``build_device_step`` (on for the strongsort preset), so the host
    list API and the engine read a config identically."""
    tracker.max_staleness = float(cfg.get("max_staleness", 1.0))
    tracker.min_hits = int(cfg.get("min_hits", 3))
    tracker.iou_threshold = float(cfg.get("iou_threshold", 0.3))
    tracker.speed_window = float(cfg.get("speed_window", 0.75))
    tracker.det_capacity = int(cfg.get("det_capacity", 100))
    slots_cfg = cfg.get("track_slots")
    tracker.track_slots = int(slots_cfg) if slots_cfg else \
        max(64, tracker.det_capacity)
    if tracker.track_slots < tracker.det_capacity:
        import warnings
        warnings.warn(
            f"track_slots={tracker.track_slots} < det_capacity="
            f"{tracker.det_capacity}: bursts of new objects will "
            f"silently drop tracks", stacklevel=3)
    backend = str(cfg.get("backend") or "").lower()
    tracker.nsa = bool(cfg.get("nsa", backend == "strongsort"))


class SortTracker(Tracker):
    """``device`` defaults to the card; ``device="cpu"`` runs the plain
    PyTorch path."""

    def __init__(self, cfg: dict, device: DeviceLike = None):
        self._parse(cfg)
        self.device = resolve_device(device)
        self._step = self._make_step(cfg)
        self._state: SortState = init_state(self.track_slots, self.device)
        self._t0: Optional[float] = None

    def _parse(self, cfg: dict) -> None:
        """The backend's config knobs (the other backends add theirs)."""
        parse_common_cfg(self, cfg)
        self.association = str(cfg.get("association", "greedy"))

    def _make_step(self, cfg: dict):
        """The backend's single-frame step (``sort.make_sort_step``'s
        contract)."""
        return make_sort_step(
            self.iou_threshold, self.max_staleness, self.speed_window,
            self.min_hits, association=self.association, nsa=self.nsa)

    @property
    def state(self) -> SortState:
        return self._state

    def reset(self) -> None:
        self._state = init_state(self.track_slots, self.device)
        self._t0 = None

    @torch.inference_mode()
    def update(self, detections: Iterable[Detection], timestamp: float,
               projector: Optional[HomographyProjector] = None
               ) -> List[Detection]:
        det_list = list(detections)
        for det in det_list:   # stale enrichment is cleared on entry
            det.track_id = None
            det.distance_m = None
            det.speed_kmh = None
        if len(det_list) > self.det_capacity:
            raise ValueError(
                f"{len(det_list)} detections exceed det_capacity="
                f"{self.det_capacity}")

        if self._t0 is None:
            self._t0 = float(timestamp)
        ts = np.float32(float(timestamp) - self._t0)

        cap = self.det_capacity
        boxes = np.zeros((cap, 4), np.float32)
        cls_id = np.zeros((cap,), np.int32)
        conf = np.zeros((cap,), np.float32)
        valid = np.zeros((cap,), bool)
        for i, d in enumerate(det_list):
            boxes[i] = (d.x1, d.y1, d.x2, d.y2)
            cls_id[i] = d.cls_id
            conf[i] = d.conf
            valid[i] = True

        proj = None
        if projector is not None:
            if not isinstance(projector, HomographyProjector):
                raise TypeError("device tracker requires a HomographyProjector")
            if projector.device != self.device:
                raise ValueError(
                    f"projector on {projector.device}, tracker on "
                    f"{self.device}")
            proj = projector.device_params()

        dev = self.device
        self._state, out = self._step(
            self._state, torch.from_numpy(boxes).to(dev),
            torch.from_numpy(cls_id).to(dev), torch.from_numpy(conf).to(dev),
            torch.from_numpy(valid).to(dev),
            torch.tensor(ts, dtype=torch.float32, device=dev), proj)

        ids = out.track_id.cpu().numpy()
        dist = out.distance_m.cpu().numpy()
        spd = out.speed_kmh.cpu().numpy()
        for i, det in enumerate(det_list):
            det.track_id = int(ids[i]) if ids[i] > 0 else None
            det.distance_m = float(dist[i]) if np.isfinite(dist[i]) else None
            det.speed_kmh = float(spd[i]) if np.isfinite(spd[i]) else None
        return det_list

    def close(self) -> None:
        self.reset()
