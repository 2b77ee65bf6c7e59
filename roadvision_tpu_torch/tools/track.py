"""Offline tracking: run the full pipeline over a source, write MOT output
— the port of ``tools/track.py``.

Runs the engine (preprocess → detect → SORT → geometry per the config)
over any video source and writes the MOT Challenge text format —
``frame,id,bb_left,bb_top,bb_width,bb_height,conf,x,y,z`` (frame and id
1-based; x,y = ground-plane meters when geometry is enabled, else -1) —
so tracks can be scored with standard MOT tooling, plus an optional
annotated recording.

Usage:
  python -m roadvision_tpu_torch.tools.track --source clip.avi --out t.txt
  python -m roadvision_tpu_torch.tools.track --source synthetic:4 \
      --frames 64 --out t.txt --weights assets/yolov8n_synthetic_256.npz \
      --record annotated.avi [--device cuda|cpu]
  python -m roadvision_tpu_torch.tools.track --source clip.avi --out t.txt \
      --gt gt/gt.txt
      # scores the run in-process: MOTA, IDF1, HOTA, id switches, misses,
      # false positives (one JSON line on stdout)

Same flags as the JAX tool plus ``--device``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..config import load_config
from ..io_video import VideoSource, make_writer
from ..runtime import PipelineEngine
from ..utils import get_logger
from ..vis import draw_detections

log = get_logger("roadvision.track")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", required=True,
                    help="video path / image dir / synthetic[:N] / camera")
    ap.add_argument("--out", required=True, help="MOT-format output file")
    ap.add_argument("--config", default=None,
                    help="pipeline config (detection+tracking enabled "
                         "automatically)")
    ap.add_argument("--weights", default=None,
                    help="override detect.model")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--conf", type=float, default=None)
    from ..track.registry import BACKENDS
    ap.add_argument("--backend", default=None,
                    choices=sorted(BACKENDS),
                    help="override tracking.backend")
    ap.add_argument("--record", default=None,
                    help="also write an annotated video here")
    ap.add_argument("--gt", default=None,
                    help="MOT-format ground-truth file: score the run "
                         "(MOTA, id switches, misses, FPs) after tracking")
    ap.add_argument("--eval-iou", type=float, default=0.5,
                    help="IoU match threshold for --gt scoring")
    ap.add_argument("--interpolate", type=int, default=0, metavar="N",
                    help="fill per-identity gaps of <= N frames with "
                         "linearly interpolated boxes (the standard MOT "
                         "postprocess; 0 = off)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    cfg.setdefault("detect", {})["enabled"] = True
    cfg.setdefault("tracking", {})["enabled"] = True
    if args.weights:
        cfg["detect"]["model"] = args.weights
    if args.conf is not None:
        cfg["detect"]["conf_thres"] = args.conf
    if args.backend:
        cfg["tracking"]["backend"] = args.backend
    cam = cfg.get("camera", {}) or {}

    vs = VideoSource(source=args.source,
                     width=args.width or cam.get("width", 1280),
                     height=args.height or cam.get("height", 720),
                     fps_request=cam.get("fps_request", 30),
                     num_frames=args.frames, device=args.device)
    engine = PipelineEngine(cfg, device=args.device)
    writer = make_writer(args.record) if args.record else None

    frame_rows = []          # per frame: (x1, y1, x2, y2, id, conf, gx, gy)
    n_frames = 0
    n_tracks = set()
    try:
        for res in engine.stream(vs, max_frames=args.frames,
                                 want_proc=writer is not None):
            n_frames += 1
            rows = []
            for d in res.detections:
                if d.track_id is None:
                    continue
                n_tracks.add(d.track_id)
                gx = gy = -1.0
                if d.distance_m is not None and engine.projector is not None:
                    pt = engine.projector.project_bbox(
                        (d.x1, d.y1, d.x2, d.y2))
                    if pt is not None:
                        gx, gy = pt
                rows.append((d.x1, d.y1, d.x2, d.y2, int(d.track_id),
                             d.conf, gx, gy))
            frame_rows.append(rows)
            if writer is not None:
                proc = np.ascontiguousarray(res.proc)
                if not proc.flags.writeable \
                        or np.shares_memory(proc, res.raw):
                    proc = proc.copy()
                if res.detections:
                    draw_detections(proc, res.detections)
                writer.write(proc)
    finally:
        if writer is not None:
            writer.release()
        vs.release()

    if args.interpolate > 0:
        from ..track.postprocess import interpolate_gaps
        before = sum(len(r) for r in frame_rows)
        frame_rows = interpolate_gaps(frame_rows, args.interpolate)
        added = sum(len(r) for r in frame_rows) - before
        log.info("interpolated %d gap rows (max_gap=%d)", added,
                 args.interpolate)

    lines = []
    for f, rows in enumerate(frame_rows, start=1):
        for (x1, y1, x2, y2, tid, conf, gx, gy) in rows:
            lines.append(
                f"{f},{tid},{x1:.2f},{y1:.2f},{x2 - x1:.2f},"
                f"{y2 - y1:.2f},{conf:.4f},{gx:.2f},{gy:.2f},-1")

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + ("\n" if lines else ""))
    log.info("wrote %d MOT rows (%d tracks over %d frames) to %s",
             len(lines), len(n_tracks), n_frames, out)

    if args.gt:
        import json

        from ..track.eval import evaluate_all
        gt_frames = read_mot(args.gt, n_frames)
        pred_frames = read_mot(out, n_frames)
        result = evaluate_all(gt_frames, pred_frames,
                              iou_thres=args.eval_iou)
        print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                          for k, v in result.items()}))
    return 0


def read_mot(path, n_frames: int):
    """MOT Challenge text → frames[f] = [(x1,y1,x2,y2,id)], 0-based frames
    (``tools/track.py::read_mot``). Rows with conf == 0 are ignored (the
    MOT gt convention for don't-care regions); frames beyond
    ``n_frames`` extend the list."""
    frames: list = [[] for _ in range(n_frames)]
    for ln in Path(path).read_text().splitlines():
        parts = ln.replace(" ", "").split(",")
        if len(parts) < 6 or not parts[0]:
            continue
        f = int(float(parts[0])) - 1
        tid = int(float(parts[1]))
        x, y, w, h = (float(v) for v in parts[2:6])
        if len(parts) > 6 and float(parts[6]) == 0.0:
            continue
        while f >= len(frames):
            frames.append([])
        frames[f].append((x, y, x + w, y + h, tid))
    return frames


if __name__ == "__main__":
    raise SystemExit(main())
