"""Config layer — a copy of ``roadvision_tpu/config.py``: YAML plus a
recursive deep merge over hardcoded defaults, with the JAX package's
keys and defaults, so one config file or dict drives both packages
(``configs/default.yaml`` and the demo configs load unchanged). The
``tpu`` section keeps its name (batch size, track slots, compute dtype,
``watchdog_s``) for that reason.

  - user YAML deep-merged over :data:`DEFAULTS` (dicts merge key-wise,
    scalars and lists replace wholesale);
  - ``None`` branches in user YAML become ``{}`` so ``.get()`` chains
    never crash;
  - the project root is found by walking up from this file for a
    ``configs/`` directory; the default config is
    ``<root>/configs/default.yaml``.
"""
from __future__ import annotations

from copy import deepcopy
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

# The reference's public default schema (values must match src/config.py:5-71
# key for key), expressed compactly; the "tpu" section is an additive
# extension absent from the reference.
DEFAULTS: Dict[str, Any] = {
    "camera": dict(source=0, width=1280, height=720, fps_request=30,
                   backend="auto",
                   # additive: one entry per stream for the sharded
                   # multi-camera engine (tpu.mesh.enable) — bare source
                   # specs or dicts overriding camera keys per stream
                   sources=[]),
    "preview": dict(
        show_fps=True,
        compare=dict(enable=True, layout="h", label_raw="RAW",
                     label_proc="PROC", divider_px=4),
        # quality: JPEG quality of the MJPEG recorder
        record=dict(enable=False, path="out_compare.mp4", fps=30,
                    quality=85,
                    # additive: event-gated recording — write only
                    # around activity (pre/post roll in frames)
                    events_only=False, pre_roll=30, post_roll=60,
                    min_detections=1),
    ),
    "preprocess": dict(
        enabled=False, chain=[],
        # contrast_thresh: number (reference parity), or "auto" —
        #   calibrated as auto_ratio x percentile(auto_pct) of the
        #   per-frame statistic over the first (clean) frames seen, or
        #   explicitly via PreprocessPipeline.calibrate_gate /
        #   tools/calibrate_gate.py.
        # stat: "span" (reference-exact max-min) | "pspan" (robust
        #   p99.5-p0.5 on a stride-4 subsample).
        # impulse_thresh: None | float — additionally run the chain on
        #   frames whose impulse residual (mean |gray - median3(gray)|,
        #   stride-4 subsample) is >= this; closes the contrast gate's
        #   structural rain blindness.
        auto_gate=dict(enable_low_contrast_gate=False, contrast_thresh=20.0,
                       stat="span", impulse_thresh=None,
                       auto_ratio=0.85, auto_pct=10.0),
    ),
    "detect": dict(enabled=False, backend="ultralytics", model="yolov8n.pt",
                   device="auto", conf_thres=0.25, iou_thres=0.7, max_det=100,
                   classes_keep=[], rect=True,
                   # int8 mode only: auto-calibrate static activation
                   # scales from the first N stream frames (0 = dynamic)
                   int8_calibration=0,
                   # motion-adaptive inference: on near-static scenes
                   # skip the detector forward and coast the tracker
                   # with the last detections (runtime/engine.py
                   # build_coast_step; thresh in u8 thumbnail levels)
                   temporal_gate=dict(enable=False, thresh=1.5,
                                      max_skip_batches=3),
                   # tiled (sliced) small-object inference (ops/tiling.py):
                   # overlapping native-res crops + optional full-frame
                   # pass, merged by one global NMS; detect task only
                   tiling=dict(enable=False, tile=640, overlap=0.25,
                               full_frame=True),
                   # test-time augmentation (ops/tta.py): ultralytics'
                   # predict(augment=True) — 3 scaled/mirrored passes,
                   # one merged NMS; accuracy-over-speed, detect task only
                   tta=False,
                   # rtdetr only: decode the top-N encoder proposals
                   # instead of the published 300. RT-DETR queries ARE
                   # the encoder's top-k (no learned query embeddings),
                   # so fewer queries is a valid smaller top-k with the
                   # same weights; decoder cost is linear in N. Must be
                   # >= max_det. None = auto: max(100, max_det);
                   # set 300 explicitly for published-behavior parity.
                   num_queries=None,
                   # rtdetr only: run just the first K decoder
                   # refinement layers (1..6; None = all). Deep
                   # supervision trains a prediction-head pair per
                   # layer, so layer K is a trained exit; cost is
                   # linear in K.
                   decoder_layers=None),
    "tracking": dict(enabled=False, backend="sort", max_staleness=1.0,
                     min_hits=3, iou_threshold=0.3, speed_window=0.75,
                     association="greedy",
                     # additive: learned re-id embedder checkpoint for
                     # the appearance backends (track/reid.py; None =
                     # handcrafted grid descriptor)
                     reid_weights=None),
    "geometry": dict(
        enabled=False,
        projector=dict(type="homography", image_points=[], world_points=[],
                       origin=[0.0, 0.0], max_distance=1_000_000.0),
    ),
    "vis": dict(draw=dict(det=True, thickness=2, font_scale=0.6,
                      # additive: per-identity motion trails
                      # (vis.TrailRenderer; 0 = off)
                      trails=0)),
    # additive: traffic analytics over tracked detections
    # (roadvision_tpu/analytics.py — line counting, zone occupancy)
    "analytics": dict(enabled=False, stale_after=5.0, lines=[], zones=[],
                      log_path=None,
                      stopped=dict(enable=False, after_s=2.0,
                                   move_frac=0.08, min_speed_kmh=3.0,
                                   polygon=None, classes=None)),
    "tpu": dict(batch_size=8, track_slots=None, compute_dtype="bfloat16",
                watchdog_s=60.0, sampled_preprocess=False,
                mesh=dict(enable=False, axis="data", devices=None)),
}


def merge(base: Dict[str, Any], override: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Recursively merge ``override`` into a deep copy of ``base``.

    Dicts merge key-wise; anything else (scalars, lists) replaces wholesale.
    Mirrors reference semantics (src/config.py:73-81).
    """
    out = deepcopy(base)
    for key, val in (override or {}).items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = merge(out[key], val)
        else:
            out[key] = val
    return out


def sanitize_none(node: Any) -> Any:
    """Replace ``None`` dict branches with ``{}`` (src/config.py:101-106)."""
    if node is None:
        return {}
    if isinstance(node, dict):
        return {k: sanitize_none(v) for k, v in node.items()}
    return node


def project_root() -> Path:
    """Walk up from this file looking for a ``configs/`` dir (src/config.py:83-89)."""
    here = Path(__file__).resolve()
    for candidate in [here, *here.parents]:
        if (candidate / "configs").exists():
            return candidate
    return Path.cwd()


def load_config(path: Optional[str] = None) -> Dict[str, Any]:
    """Load a YAML config merged over :data:`DEFAULTS` (src/config.py:91-108)."""
    root = project_root()
    cfg_path = Path(path) if path else (root / "configs" / "default.yaml")
    if not cfg_path.exists():
        raise FileNotFoundError(f"config file not found: {cfg_path}")
    with open(cfg_path, "r", encoding="utf-8") as fh:
        user_cfg = yaml.safe_load(fh) or {}
    return merge(DEFAULTS, sanitize_none(user_cfg))
