"""YOLOv8-obb / YOLO11-obb training — the port of
``roadvision_tpu/models/yolo/train_obb.py``.

Task-aligned assignment with rotated geometry (the anchor centre inside
the rotated gt box, ProbIoU as the overlap, ``ops/obb.py::probiou_pairs``
with its eps), box term ``1 − ProbIoU`` (the angle branch learns through
it), DFL on the target's unrotated extent about the anchor, class BCE;
gains 7.5 / 0.5 / 1.5. Gt rotated boxes are (B, M, 5): cx, cy, w, h in
input pixels, θ in radians in [−π/4, 3π/4).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ...ops.obb import probiou_pairs
from .train import (Objective, class_scores_at_gt, detection_total,
                    dfl_sum, head_logits, make_train_step, select_aligned,
                    sigmoid_bce, timed)
from .train_seg import head_rows
from .yolov8_obb import decode_rbox


def rotated_inside(anchors: torch.Tensor, gt_rb: torch.Tensor,
                   gt_mask: torch.Tensor) -> torch.Tensor:
    """``rotated_inside`` :47: (N, 2) anchor centres × (B, M, 5) gt
    rboxes → (B, M, N) bool, the centre strictly inside the box."""
    dx = anchors[None, None, :, 0] - gt_rb[..., 0:1]
    dy = anchors[None, None, :, 1] - gt_rb[..., 1:2]
    cos = torch.cos(gt_rb[..., 4:5])
    sin = torch.sin(gt_rb[..., 4:5])
    lx = dx * cos + dy * sin
    ly = -dx * sin + dy * cos
    inside = (lx.abs() < gt_rb[..., 2:3] / 2.0) \
        & (ly.abs() < gt_rb[..., 3:4] / 2.0)
    return inside & gt_mask[..., None]


def task_aligned_assign_rotated(scores, pred_rb, anchors, gt_rb, gt_cls,
                                gt_mask, topk: int = 10, alpha: float = 0.5,
                                beta: float = 6.0):
    """``task_aligned_assign_rotated`` :63: the selection of
    ``train.task_aligned_assign`` with the rotated gate and ProbIoU."""
    with timed("assign"):
        inside = rotated_inside(anchors, gt_rb, gt_mask)
        overlaps = probiou_pairs(gt_rb[:, :, None, :],
                                 pred_rb[:, None, :, :]).clamp(min=0.0)
        align = (class_scores_at_gt(scores, gt_cls) ** alpha) \
            * (overlaps ** beta)
        align = torch.where(inside, align, torch.zeros_like(align))
        return select_aligned(align, inside, overlaps, gt_rb, gt_cls,
                              scores.shape[-1], topk)


def obb_parts(model: nn.Module, images, gt_rboxes, gt_cls, gt_mask):
    """The :class:`~.train.Objective` parts of ``obb_loss`` :115;
    gt_rboxes (B, M, 5). Combined as the detection terms are."""
    feats, outs = model.features_and_head(images)
    angle = (torch.sigmoid(head_rows(model, feats)[..., 0]) - 0.25) * math.pi
    box_logits, cls_logits, pts, strides, hw = head_logits(outs, model.nc)
    pred_rb = decode_rbox(box_logits, angle, hw)
    scores = torch.sigmoid(cls_logits)

    fg, _, target_scores, target_rb = task_aligned_assign_rotated(
        scores.detach(), pred_rb.detach(), pts * strides[:, None],
        gt_rboxes, gt_cls, gt_mask)

    weight = target_scores.sum(-1) * fg
    iou = probiou_pairs(pred_rb, target_rb)
    # DFL on the unrotated extent of the target rbox
    cxy, wh2 = target_rb[..., :2], target_rb[..., 2:4] / 2.0
    t_ltrb = torch.cat([
        pts[None] - (cxy - wh2) / strides[None, :, None],
        (cxy + wh2) / strides[None, :, None] - pts[None],
    ], dim=-1)
    sums = {"box": ((1.0 - iou) * weight).sum(),
            "cls": sigmoid_bce(cls_logits, target_scores).sum(),
            "dfl": dfl_sum(box_logits, t_ltrb, weight)}
    return sums, {"score_sum": target_scores.sum()}, {"num_fg": fg.sum()}


obb_loss = Objective(obb_parts, detection_total)


def make_train_step_obb(lr: float = 1e-3, clip_norm: float = 10.0):
    """``make_train_step_obb`` :176: the v8 step, gt rboxes for boxes."""
    return make_train_step(obb_loss, lr, clip_norm)
