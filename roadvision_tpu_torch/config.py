"""Config defaults and deep merge — a trimmed copy of
``roadvision_tpu/config.py``: the sections the port reads, with the JAX
package's keys and defaults, and the same merge (dicts merge key-wise,
scalars and lists replace wholesale), so one config dict drives both
engines. The ``tpu`` section keeps its name (batch size, track slots,
compute dtype) for that reason.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Optional

DEFAULTS: Dict[str, Any] = {
    "preprocess": dict(
        enabled=False, chain=[],
        auto_gate=dict(enable_low_contrast_gate=False, contrast_thresh=20.0,
                       stat="span", impulse_thresh=None,
                       auto_ratio=0.85, auto_pct=10.0),
    ),
    "detect": dict(enabled=False, backend="ultralytics", model="yolov8n.pt",
                   device="auto", conf_thres=0.25, iou_thres=0.7, max_det=100,
                   classes_keep=[], rect=True,
                   temporal_gate=dict(enable=False, thresh=1.5,
                                      max_skip_batches=3),
                   tiling=dict(enable=False, tile=640, overlap=0.25,
                               full_frame=True),
                   tta=False),
    "tracking": dict(enabled=False, backend="sort", max_staleness=1.0,
                     min_hits=3, iou_threshold=0.3, speed_window=0.75,
                     association="greedy"),
    "geometry": dict(
        enabled=False,
        projector=dict(type="homography", image_points=[], world_points=[],
                       origin=[0.0, 0.0], max_distance=1_000_000.0),
    ),
    "tpu": dict(batch_size=8, track_slots=None, compute_dtype="bfloat16",
                sampled_preprocess=False),
}


def merge(base: Dict[str, Any],
          override: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Recursively merge ``override`` into a deep copy of ``base``."""
    out = deepcopy(base)
    for key, val in (override or {}).items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = merge(out[key], val)
        else:
            out[key] = val
    return out
