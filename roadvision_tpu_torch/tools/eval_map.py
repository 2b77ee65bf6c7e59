"""Score a detector's mAP on a dataset — the port of ``tools/eval_map.py``.

Box mAP (YOLO dir or COCO JSON), mask mAP (``-seg``, COCO JSON),
keypoint OKS mAP (``-pose``, COCO JSON) or rotated-box mAP (``-obb``,
YOLO-OBB dir), by the task the weights name says or ``--task``; optional
tiling or TTA to compare against the plain pass. The detector runs on
``--device`` (the card unless "cpu" is named). Prints one JSON line.

Usage:
  python -m roadvision_tpu_torch.tools.eval_map --data coco.json \\
      --weights yolov8n.pt --iou-thres 0.5,0.75
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..detect import build_detector
from ..detect import dataset as ds
from ..detect import eval as ev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--weights", default="yolov8n.pt")
    ap.add_argument("--task", default="auto",
                    choices=["auto", "detect", "segment", "pose", "obb"])
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--conf", type=float, default=0.001)
    ap.add_argument("--iou-thres", default="0.5")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--tile", type=int, default=0,
                    help="tiled inference crop size (0 = off; detect only)")
    ap.add_argument("--tile-overlap", type=float, default=0.25)
    ap.add_argument("--tta", action="store_true",
                    help="test-time augmentation (detect only)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    task = args.task
    if task == "auto":
        name = str(args.weights).lower()
        task = "segment" if "-seg" in name else "pose" if "-pose" in name \
            else "obb" if "-obb" in name else "detect"

    det = build_detector({"backend": "ultralytics", "model": args.weights,
                          "task": task, "conf_thres": args.conf,
                          "iou_thres": 0.7, "max_det": 300,
                          "imgsz": args.imgsz, "classes_keep": [],
                          "tiling": {"enable": args.tile > 0,
                                     "tile": args.tile or 640,
                                     "overlap": args.tile_overlap},
                          "tta": args.tta}, device=args.device)
    thresholds = [float(t) for t in args.iou_thres.split(",")]

    if task == "segment":
        images, _boxes, gt_cls, gt_mask, seg = ds.load_coco_seg_json(
            args.data, imgsz=args.imgsz, limit=args.limit)
        # prototype-resolution gt → letterbox pixels (×4 nearest)
        gt_masks = [np.repeat(np.repeat(seg[i][gt_mask[i]] > 0.5, 4, 1),
                              4, 2) for i in range(images.shape[0])]
        gt_cls_l = [gt_cls[i][gt_mask[i]] for i in range(images.shape[0])]
        result = ev.evaluate_segmenter(det, images, gt_masks, gt_cls_l,
                                       thresholds)
    elif task == "pose":
        images, gt_boxes, _cls, gt_mask, kpts = ds.load_coco_kpts_json(
            args.data, imgsz=args.imgsz, limit=args.limit)
        result = ev.evaluate_pose(det, images, gt_boxes, kpts, gt_mask,
                                  thresholds)
    elif task == "obb":
        images, gt_rb, gt_cls, gt_mask = ds.load_yolo_obb_dir(
            args.data, imgsz=args.imgsz, limit=args.limit)
        result = ev.evaluate_obb(det, images, gt_rb, gt_cls, gt_mask,
                                 thresholds)
    else:
        images, gt_boxes, gt_cls, gt_mask = ds.load_dataset(
            args.data, imgsz=args.imgsz, limit=args.limit)
        result = ev.evaluate_detector(det, images, gt_boxes, gt_cls,
                                      gt_mask, thresholds)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
