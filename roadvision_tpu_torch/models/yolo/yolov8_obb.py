"""The oriented-box head (YOLOv8-obb and YOLO11-obb) — the port of
``roadvision_tpu/models/yolo/yolov8_obb.py``.

A per-level ``cv4`` branch to one raw angle per anchor, θ =
(sigmoid(raw) − 0.25) · π, and ultralytics' ``dist2rbox``: the DFL ltrb
offsets' midpoint rotated by θ about the anchor, size lt + rb, all times
the stride → (cx, cy, w, h, θ) in input pixels.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from .yolov8 import YOLOBase, anchor_points, branch, dfl_decode, run_branch

NE = 1   # raw angle channels per anchor

# DOTA-v1.0 category names (what ultralytics' -obb checkpoints are
# trained on), index order of the released models
DOTA_NAMES = (
    "plane", "ship", "storage tank", "baseball diamond", "tennis court",
    "basketball court", "ground track field", "harbor", "bridge",
    "large vehicle", "small vehicle", "helicopter", "roundabout",
    "soccer ball field", "swimming pool",
)


def attach_obb(model: YOLOBase) -> YOLOBase:
    head = model.layers[model.head_key]
    ch3 = head.cv2[0][0].weight.shape[1]
    head.cv4 = nn.ModuleList(branch(m[0].weight.shape[1], max(ch3 // 4, NE),
                                    NE) for m in head.cv2)
    model.task = "obb"
    return model


def decode_rbox(box_logits: torch.Tensor, angle: torch.Tensor,
                hw_per_level) -> torch.Tensor:
    """DFL logits (B, N, 64) + θ (B, N) → rboxes (B, N, 5)."""
    pts, strides = anchor_points(hw_per_level, box_logits.device)
    ltrb = dfl_decode(box_logits)
    lt, rb = ltrb[..., :2], ltrb[..., 2:]
    xf = (rb[..., 0] - lt[..., 0]) / 2.0
    yf = (rb[..., 1] - lt[..., 1]) / 2.0
    cos, sin = torch.cos(angle), torch.sin(angle)
    cx = (xf * cos - yf * sin + pts[None, :, 0]) * strides[None]
    cy = (xf * sin + yf * cos + pts[None, :, 1]) * strides[None]
    wh = (lt + rb) * strides[None, :, None]
    return torch.stack([cx, cy, wh[..., 0], wh[..., 1], angle], dim=-1)


def obb_outputs(model: YOLOBase, feats, outs):
    """→ (rboxes (B, N, 5), scores (B, N, nc))."""
    head = model.layers[model.head_key]
    box = torch.cat([b.flatten(2) for b, _ in outs], 2).transpose(1, 2)
    cls = torch.cat([c.flatten(2) for _, c in outs], 2).transpose(1, 2)
    raw = torch.cat([run_branch(head.cv4[lvl], f).flatten(1)
                     for lvl, f in enumerate(feats)], dim=1)
    angle = (torch.sigmoid(raw) - 0.25) * math.pi
    hw = [(b.shape[2], b.shape[3]) for b, _ in outs]
    return decode_rbox(box, angle, hw), torch.sigmoid(cls)
