"""Tracker registry — the port of ``roadvision_tpu/track/registry.py``.

Two factories, one per calling convention, dispatching on the same
``backend`` key so a config drives both paths identically:

  * :func:`build_tracker` — host-facing Tracker objects with the
    ``update(dets, ts, projector)`` list API;
  * :func:`build_device_step` — the single-frame tensor step the engine
    runs over a batch's frames.

Only ``sort`` is ported. The JAX package's other backends raise
``NotImplementedError`` by name; an unknown name is a ``ValueError``.
"""
from __future__ import annotations

from typing import Any, Dict

from ..utils.device import DeviceLike
from .base import Tracker
from .sort import make_sort_step
from .sort_tracker import SortTracker

BACKENDS = {"sort": SortTracker}
NOT_PORTED = ("bytetrack", "ocsort", "deepsort", "strongsort", "botsort")


def _backend(cfg: Dict[str, Any]) -> str:
    name = str(cfg.get("backend") or "sort").lower()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"tracking.backend {name!r} is not ported to roadvision_tpu_torch "
            f"yet (sort only)")
    if name not in BACKENDS:
        raise ValueError(f"unknown tracking backend: {name}")
    return name


def build_tracker(cfg: Dict[str, Any], device: DeviceLike = None) -> Tracker:
    return BACKENDS[_backend(cfg)](cfg, device=device)


def build_device_step(cfg: Dict[str, Any]):
    """Single-frame tracking step from a ``tracking:`` config:
    ``step(state, boxes (D,4), cls (D,), conf (D,), dvalid (D,), ts (),
    proj) → (state', SortOutput)``."""
    name = _backend(cfg)
    if cfg.get("gmc"):
        raise NotImplementedError("tracking.gmc is not ported to "
                                  "roadvision_tpu_torch yet")
    # NSA Kalman: measurement noise scaled by (1 - conf)
    nsa = bool(cfg.get("nsa", name == "strongsort"))
    return make_sort_step(
        float(cfg.get("iou_threshold", 0.3)),
        float(cfg.get("max_staleness", 1.0)),
        float(cfg.get("speed_window", 0.75)),
        int(cfg.get("min_hits", 3)),
        association=str(cfg.get("association", "greedy")),
        nsa=nsa)
