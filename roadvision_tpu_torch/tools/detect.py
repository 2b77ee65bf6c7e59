"""Run detection on images / a video source, write annotated outputs —
the port of ``tools/detect.py``.

Usage:
  python -m roadvision_tpu_torch.tools.detect --source images_dir \
      --out out_dir [--weights W] [--device cuda|cpu]
  python -m roadvision_tpu_torch.tools.detect --source synthetic \
      --frames 30 --out out_dir

Same flags as the JAX tool (``--dtype bfloat16|float32|int8``, ``--task
auto|detect|segment|pose|obb``, ``--tile N`` with ``--tile-overlap``,
``--tta``) plus ``--device``. Segment masks are pasted with the
detector's ``last_letterbox_meta``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..detect import build_detector
from ..io_video import VideoSource
from ..utils import get_logger
from ..vis import draw_overlays

log = get_logger("roadvision.detect")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--weights", default="yolov8n.pt")
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--iou", type=float, default=0.7)
    ap.add_argument("--max-det", type=int, default=100)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--classes", default="",
                    help="comma-separated class ids to keep")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--rect", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="minimal-rectangle letterbox (ultralytics predict "
                         "default); --no-rect = square canvas")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "int8"],
                    help="conv compute dtype (int8 = quantized path)")
    ap.add_argument("--task", default="auto",
                    choices=["auto", "detect", "segment", "pose", "obb"],
                    help="segment = YOLOv8-seg instance masks (alpha-"
                         "blended under the boxes); pose = YOLOv8-pose "
                         "COCO-17 keypoints + skeleton; obb = "
                         "YOLOv8-obb rotated-box outlines (auto: from "
                         "the weights name / checkpoint head)")
    ap.add_argument("--tile", type=int, default=0,
                    help="tiled small-object inference: crop size "
                         "(0 = off; detect task only)")
    ap.add_argument("--tile-overlap", type=float, default=0.25)
    ap.add_argument("--tta", action="store_true",
                    help="test-time augmentation (scales 1/0.83/0.67 + "
                         "mirrored pass, one merged NMS; detect task only)")
    ap.add_argument("--mask-alpha", type=float, default=0.45)
    ap.add_argument("--json", action="store_true",
                    help="also write per-frame detections json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    keep = [int(c) for c in args.classes.split(",") if c.strip()]
    det = build_detector({"backend": "ultralytics", "model": args.weights,
                          "conf_thres": args.conf, "iou_thres": args.iou,
                          "max_det": args.max_det, "imgsz": args.imgsz,
                          "classes_keep": keep, "rect": args.rect,
                          "compute_dtype": args.dtype, "task": args.task,
                          "tiling": {"enable": args.tile > 0,
                                     "tile": args.tile or 640,
                                     "overlap": args.tile_overlap},
                          "tta": args.tta}, device=args.device)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    vs = VideoSource(source=args.source, width=640, height=480,
                     num_frames=args.frames, device=args.device)
    from PIL import Image
    records = []
    i = 0
    while True:
        fr = vs.read()
        if not fr.ok:
            break
        dets = det.infer(fr.image)
        img = np.ascontiguousarray(fr.image)
        draw_overlays(img, dets,
                      lb_meta=(det.last_letterbox_meta()
                               if det.task == "segment" else None),
                      mask_alpha=args.mask_alpha)
        Image.fromarray(img[..., ::-1]).save(out_dir / f"frame_{i:05d}.jpg")
        if args.json:
            records.append([dict(
                {"bbox": [d.x1, d.y1, d.x2, d.y2], "conf": d.conf,
                 "cls_id": d.cls_id, "cls_name": d.cls_name},
                **({"rbox": np.asarray(d.rbox).tolist()}
                   if d.rbox is not None else {}),
                **({"keypoints": np.asarray(d.keypoints).tolist()}
                   if d.keypoints is not None else {}),
            ) for d in dets])
        i += 1
        if args.frames is not None and i >= args.frames:
            break
    if args.json:
        (out_dir / "detections.json").write_text(json.dumps(records))
    log.info("wrote %d annotated frames to %s", i, out_dir)
    vs.release()
    det.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
