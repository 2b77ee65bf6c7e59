"""Legacy overlay renderer (a copy of ``roadvision_tpu/vis/legacy.py``;
reference parity: bis/draw.py — dead code).

The reference tree carries an older, unreferenced duplicate of
``draw_detections`` without ID/distance/speed labels (SURVEY.md §1 "dead"
row). Provided here for API completeness; nothing in the framework imports
it — prefer :mod:`roadvision_tpu_torch.vis.draw`.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

from ..detect.types import Detection
from .draw import COLOR_TABLE, draw_rect, fill_rect, put_text, text_size


def draw_detections(image: np.ndarray, detections: Iterable[Detection],
                    thickness: int = 2, font_scale: float = 0.6) -> None:
    """Boxes + class/conf label only (no track id, no metrics)."""
    thickness = max(1, int(thickness))
    for det in detections:
        if det is None:
            continue
        color = COLOR_TABLE[det.cls_id % len(COLOR_TABLE)]
        x1, y1, x2, y2 = map(int, (det.x1, det.y1, det.x2, det.y2))
        if x2 <= x1 or y2 <= y1:
            continue
        draw_rect(image, x1, y1, x2, y2, color, thickness)
        label = f"{det.cls_name or det.cls_id} {det.conf:.2f}"
        (tw, th), baseline = text_size(label, font_scale)
        pad = 2
        top = max(0, y1 - th - baseline - pad * 2)
        fill_rect(image, x1, top, x1 + tw + pad * 2, y1, color)
        put_text(image, label, (x1 + pad, max(top + th, pad + th)),
                 (255, 255, 255), font_scale)
