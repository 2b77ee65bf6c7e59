"""Offline traffic-analytics report: run a clip, emit a JSON report — the
port of ``tools/analyze.py``.

One command that runs the full pipeline (detect → track → geometry) over
a recorded clip and writes the deployment questions' answers —
directional counts per line, zone occupancy/dwell/speed statistics,
stopped-vehicle incidents, the raw event log — as machine-readable JSON.
The pipeline runs on the card unless ``--device cpu`` is given.

Usage:
  python -m roadvision_tpu_torch.tools.analyze --source traffic.avi \
      --out report.json --line "main:0,400:1920,400" \
      --zone "junction:100,100:500,100:500,500:100,500" \
      [--config configs/default.yaml] [--stopped-after 2.0] \
      [--device cuda|cpu]

Lines/zones can come from the config's ``analytics:`` section, the CLI
flags above, or both (CLI appends).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..analytics import Analytics
from ..config import load_config
from ..io_video import VideoSource
from ..runtime import PipelineEngine
from ..utils import get_logger

log = get_logger("roadvision.analyze")


def _parse_points(spec: str):
    """'name:x,y:x,y[:x,y...]' → (name, [(x, y), ...])."""
    parts = spec.split(":")
    if len(parts) < 3:
        raise ValueError(
            f"bad geometry spec '{spec}' (want name:x,y:x,y...)")
    pts = []
    for p in parts[1:]:
        x, y = p.split(",")
        pts.append((float(x), float(y)))
    return parts[0], pts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True)
    ap.add_argument("--out", required=True, help="JSON report path")
    ap.add_argument("--config", default=None)
    ap.add_argument("--weights", default=None, help="override detect.model")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--line", action="append", default=[],
                    metavar="NAME:X,Y:X,Y",
                    help="counting line (repeatable)")
    ap.add_argument("--zone", action="append", default=[],
                    metavar="NAME:X,Y:X,Y:X,Y...",
                    help="occupancy zone polygon (repeatable)")
    ap.add_argument("--wrong-way", default=None, choices=["pos", "neg"],
                    help="flag crossings in this direction on CLI lines")
    ap.add_argument("--stopped-after", type=float, default=0.0,
                    help="enable stopped-vehicle detection after this "
                         "many still seconds (0 = off)")
    ap.add_argument("--events", action=argparse.BooleanOptionalAction,
                    default=True, help="include the raw event log")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    cfg.setdefault("detect", {})["enabled"] = True
    cfg.setdefault("tracking", {})["enabled"] = True
    if args.weights:
        cfg["detect"]["model"] = args.weights

    ana_cfg = dict(cfg.get("analytics", {}) or {})
    lines = list(ana_cfg.get("lines") or [])
    zones = list(ana_cfg.get("zones") or [])
    for spec in args.line:
        name, pts = _parse_points(spec)
        if len(pts) != 2:
            raise ValueError(f"line '{name}' needs exactly 2 points")
        lines.append({"name": name, "p1": pts[0], "p2": pts[1],
                      **({"wrong_way": args.wrong_way}
                         if args.wrong_way else {})})
    for spec in args.zone:
        name, pts = _parse_points(spec)
        zones.append({"name": name, "polygon": pts})
    ana_cfg["lines"] = lines
    ana_cfg["zones"] = zones
    if args.stopped_after > 0:
        ana_cfg["stopped"] = dict(ana_cfg.get("stopped") or {},
                                  enable=True, after_s=args.stopped_after)

    # the engine first: without a card it raises before the event log
    # (analytics.log_path) is opened
    engine = PipelineEngine(cfg, device=args.device)
    analytics = Analytics(ana_cfg)
    if not (analytics.lines or analytics.zones or analytics.stopped):
        log.warning("no lines/zones/stopped monitor configured — the "
                    "report will only carry stream totals")

    cam = cfg.get("camera", {}) or {}
    vs = VideoSource(source=args.source,
                     width=args.width or cam.get("width", 1280),
                     height=args.height or cam.get("height", 720),
                     fps_request=cam.get("fps_request", 30),
                     num_frames=args.frames, device=engine.device)

    events = []
    n_frames = 0
    n_dets = 0
    ids = set()
    t0 = t1 = None
    try:
        for res in engine.stream(vs, max_frames=args.frames,
                                 want_proc=False):
            n_frames += 1
            n_dets += len(res.detections)
            ids.update(d.track_id for d in res.detections
                       if d.track_id is not None)
            t0 = res.ts if t0 is None else t0
            t1 = res.ts
            events.extend(analytics.update(res.detections, res.ts))
    finally:
        vs.release()
        analytics.close()

    report = {
        "source": str(args.source),
        "frames": n_frames,
        "duration_s": (t1 - t0) if (t0 is not None and n_frames > 1)
        else 0.0,
        "detections_total": n_dets,
        "unique_track_ids": len(ids),
        "analytics": analytics.summary(),
    }
    if args.events:
        report["events"] = events

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    log.info("analyzed %d frames (%d events) → %s",
             n_frames, len(events), out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
