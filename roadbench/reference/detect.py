"""The detector stage, plain: the resize the detector predicts on, its
forward, and what the judge reads from it.

YOLOv8 letterboxes (Ultralytics ``LetterBox(auto=True)``: the frame
scaled by min(640/h, 640/w) with a half-pixel bilinear resize, padded
with grey 114 to a multiple of 32, RGB in [0, 1]); RT-DETR-L stretches
to 640 × 640. :func:`candidates` gives every anchor's (or query's) box in
source pixels and its class probabilities; :func:`detections` the final
set by the configuration's rules: greedy class-aware NMS (score > conf,
top 300, IoU > iou suppresses, at most max_det, then the kept classes)
for YOLOv8, threshold and top max_det for RT-DETR.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import rtdetr, yolov8
from .params import Params


def _resize(frames_u8: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H, W, 3) uint8 BGR → (N, 3, h, w) float32 RGB in [0, 255]."""
    x = frames_u8.permute(0, 3, 1, 2).float().flip(1)
    if x.shape[2:] == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=False)


def letterbox(frames_u8: torch.Tensor, size: int, stride: int = 32):
    """→ (NHWC RGB [0, 1], ratio, (left, top))."""
    h, w = frames_u8.shape[1:3]
    r = min(size / h, size / w)
    nh, nw = round(h * r), round(w * r)
    th, tw = nh + (-nh) % stride, nw + (-nw) % stride
    top, left = int(round((th - nh) / 2 - 0.1)), \
        int(round((tw - nw) / 2 - 0.1))
    x = F.pad(_resize(frames_u8, nh, nw),
              (left, tw - nw - left, top, th - nh - top), value=114.0)
    return (x / 255.0).permute(0, 2, 3, 1).contiguous(), r, (left, top)


def candidates(frames_u8: torch.Tensor, model: Dict, p: Params,
               counter: Optional[rtdetr.RowCounter] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, 3) uint8 BGR (already preprocessed) → (boxes (N, A, 4)
    xyxy in source pixels, probabilities (N, A, nc))."""
    h, w = frames_u8.shape[1:3]
    size = int(model["imgsz"])
    if model["family"] == "yolov8":
        x, r, (left, top) = letterbox(frames_u8, size)
        boxes, scores = yolov8.forward(x, p)
        off = torch.tensor([left, top, left, top], dtype=torch.float32,
                           device=boxes.device)
        boxes = (boxes - off) / r
    else:
        x = (_resize(frames_u8, size, size) / 255.0).permute(0, 2, 3, 1)
        boxes, scores = rtdetr.forward(x.contiguous(), p,
                                       int(model["num_queries"]), counter)
        boxes = boxes * torch.tensor([w, h, w, h], dtype=torch.float32,
                                     device=boxes.device)
    lim = torch.tensor([w, h, w, h], dtype=torch.float32, device=boxes.device)
    return torch.minimum(boxes.clamp(min=0), lim), scores


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(K, 4) × (M, 4) xyxy → (K, M)."""
    iw = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                 - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    ih = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                 - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = iw * ih
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1],
                                                          0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1],
                                                          0, None)
    union = area_a[:, None] + area_b[None] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def detections(boxes: np.ndarray, scores: np.ndarray, rules: Dict,
               nms: bool):
    """One frame's candidates (A, 4), (A, nc) → the final (boxes, conf,
    cls) by the detector's rules."""
    conf = scores.max(axis=1)
    cls = scores.argmax(axis=1)
    order = np.argsort(-conf, kind="stable")
    order = order[conf[order] > rules["conf_thres"]]
    if nms:
        order = order[:300]
        over = iou(boxes[order], boxes[order]) > rules["iou_thres"]
        same = cls[order][:, None] == cls[order][None, :]
        kept = []
        for i in range(len(order)):
            if not any(over[j, i] and same[j, i] for j in kept):
                kept.append(i)
        order = order[kept]
    order = order[:rules["max_det"]]
    keep = rules.get("classes_keep") or []
    if keep:
        order = order[np.isin(cls[order], keep)]
    return boxes[order], conf[order], cls[order]
