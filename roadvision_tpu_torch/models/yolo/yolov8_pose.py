"""The pose head (YOLOv8-pose and YOLO11-pose) — the port of
``roadvision_tpu/models/yolo/yolov8_pose.py``.

A per-level ``cv4`` branch to 17 × 3 raw keypoint values per anchor,
decoded as ultralytics' ``kpts_decode`` (yolov8_pose.py:83): xy = (raw ·
2 + anchor − 0.5) · stride, visibility = sigmoid(raw); ``scale_kpts``
(:112) maps them from the letterbox canvas to the source frame.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .yolov8 import YOLOBase, anchor_points, branch, decode, run_branch

KPT_SHAPE = (17, 3)   # COCO keypoints: (x, y, visibility)
NK = KPT_SHAPE[0] * KPT_SHAPE[1]


def attach_pose(model: YOLOBase) -> YOLOBase:
    head = model.layers[model.head_key]
    ch3 = head.cv2[0][0].weight.shape[1]
    head.cv4 = nn.ModuleList(branch(m[0].weight.shape[1], max(ch3 // 4, NK),
                                    NK) for m in head.cv2)
    model.task = "pose"
    return model


def decode_kpts(raw: torch.Tensor, hw_per_level) -> torch.Tensor:
    """(B, N, nk) raw → (B, N, 17, 3), xy in input pixels."""
    pts, strides = anchor_points(hw_per_level, raw.device)
    b, n = raw.shape[:2]
    y = raw.reshape(b, n, KPT_SHAPE[0], KPT_SHAPE[1])
    xy = (y[..., :2] * 2.0 + (pts[None, :, None, :] - 0.5)) \
        * strides[None, :, None, None]
    return torch.cat([xy, torch.sigmoid(y[..., 2:3])], dim=-1)


def pose_outputs(model: YOLOBase, feats, outs):
    """→ (boxes, scores, kpts (B, N, 17, 3) in input pixels)."""
    head = model.layers[model.head_key]
    boxes, scores = decode(outs, model.nc)
    raw = torch.cat([run_branch(head.cv4[lvl], f).flatten(2)
                     for lvl, f in enumerate(feats)], dim=2).transpose(1, 2)
    hw = [(b.shape[2], b.shape[3]) for b, _ in outs]
    return boxes, scores, decode_kpts(raw, hw)


def scale_kpts(kpts: torch.Tensor, ratio, pad, orig_hw) -> torch.Tensor:
    """Letterbox-space keypoints → source-frame pixels, clamped;
    visibility passes through."""
    h, w = orig_hw
    x = ((kpts[..., 0] - pad[0]) / ratio).clamp(0, w)
    y = ((kpts[..., 1] - pad[1]) / ratio).clamp(0, h)
    return torch.stack([x, y, kpts[..., 2]], dim=-1)
