"""What the serving loops draw on a processed frame — the trails, the
detections and the analytics overlay — and the camera fleet's grid of
such frames. The preview (``tools/preview.py``) and the HTTP server
(``tools/serve.py``) both draw through these, one stream or a fleet."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .draw import draw_overlays, tile_streams


def annotate(frame: np.ndarray, res, draw_cfg: dict, lb_meta,
             analytics=None, trails=None) -> list:
    """Draw on ``frame`` in place: ``res``'s trails (when a
    ``TrailRenderer`` is given), its detections (``vis.draw.det``) and
    the analytics overlay after ``analytics.update``. Returns the
    analytics events of this frame."""
    thickness = int(draw_cfg.get("thickness", 2))
    if trails is not None:
        trails.update(res.detections, res.ts)
        trails.draw(frame, thickness=thickness)
    if draw_cfg.get("det", True) and res.detections:
        draw_overlays(frame, res.detections, lb_meta=lb_meta,
                      thickness=thickness,
                      font_scale=float(draw_cfg.get("font_scale", 0.6)),
                      mask_alpha=float(draw_cfg.get("mask_alpha", 0.45)))
    if analytics is None:
        return []
    events = analytics.update(res.detections, res.ts)
    analytics.overlay(frame)
    return events


def fleet_canvas(batch, i: int, draw_cfg: dict, lb_meta,
                 labels: Sequence[str], fps: Optional[float] = None,
                 analytics: Optional[list] = None,
                 trails: Optional[list] = None
                 ) -> Tuple[np.ndarray, List[dict]]:
    """Frame ``i`` of every stream of a fleet batch (per-stream result
    lists), each annotated on a copy with that stream's analytics and
    trails, tiled into one grid canvas. Returns (canvas, the analytics
    events, each tagged with its ``stream``)."""
    tiles, events = [], []
    for s, stream_results in enumerate(batch):
        res = stream_results[i]
        frame = res.proc.copy()    # keep RAW clean
        events += [dict(ev, stream=s) for ev in annotate(
            frame, res, draw_cfg, lb_meta,
            None if analytics is None else analytics[s],
            None if trails is None else trails[s])]
        tiles.append(frame)
    return tile_streams(tiles, labels, fps=fps), events
