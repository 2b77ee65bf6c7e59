"""YOLOv8-pose / YOLO11-pose training — the port of
``roadvision_tpu/models/yolo/train_pose.py``.

The detection terms of ``train.py`` plus, on the top-K foreground anchors
(K = 64, :func:`train_seg.top_foreground`: ``lax.top_k``'s pick), the
OKS-shaped location term ``1 − exp(−d² / (2σ)² / (2·area))`` over the
labelled joints re-weighted by 17 / #labelled, and the visibility BCE;
gains pose 12.0, kobj 1.0. Gt keypoints are (B, M, 17, 3): x, y in input
pixels, v > 0 labelled.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from .train import (EPS, Objective, detection_terms, detection_total,
                    device_constant, make_train_step, sigmoid_bce)
from .train_seg import gather_rows, head_rows, top_foreground
from .yolov8_pose import KPT_SHAPE

# COCO OKS per-keypoint falloff constants (cocoeval.py convention)
OKS_SIGMAS = np.array([.26, .25, .25, .35, .35, .79, .79, .72, .72,
                       .62, .62, 1.07, 1.07, .87, .87, .89, .89],
                      np.float32) / 10.0


def pose_parts(model: nn.Module, images, gt_boxes, gt_cls, gt_mask,
               gt_kpts, kpt_topk: int = 64):
    """The :class:`~.train.Objective` parts of ``pose_loss`` :49; gt_kpts
    (B, M, 17, 3). Adds the keypoint and visibility sums over the
    selected foreground anchors and their count."""
    feats, outs = model.features_and_head(images)
    kraw = head_rows(model, feats)                           # (B, N, 51)
    sums, counts, t = detection_terms(outs, model.nc, gt_boxes, gt_cls,
                                      gt_mask)
    bs = images.shape[0]

    sel_w, sel_idx = top_foreground(t["weight"], kpt_topk)
    k = sel_idx.shape[1]
    sel_fg = (sel_w > 0).float()
    kgt = torch.gather(t["target_gt"], 1, sel_idx)
    tkpts = gather_rows(gt_kpts, kgt)                        # (B, K, 17, 3)
    kboxes = gather_rows(t["target_boxes"], sel_idx)

    kr = gather_rows(kraw, sel_idx).reshape(bs, k, *KPT_SHAPE).float()
    spts = t["pts"][sel_idx]                                 # (B, K, 2)
    sstr = t["strides"][sel_idx]                             # (B, K)
    pred_xy = (kr[..., :2] * 2.0 + (spts[:, :, None, :] - 0.5)) \
        * sstr[..., None, None]

    kpt_vis = (tkpts[..., 2] > 0).float()
    d2 = ((pred_xy - tkpts[..., :2]) ** 2).sum(-1)
    area = ((kboxes[..., 2] - kboxes[..., 0])
            * (kboxes[..., 3] - kboxes[..., 1])).clamp(min=1.0)
    sig = device_constant("oks_sigmas", OKS_SIGMAS, images.device)[None,
                                                                    None]
    e = d2 / (2.0 * sig) ** 2 / (area[..., None] + EPS) / 2.0
    factor = KPT_SHAPE[0] / (kpt_vis.sum(-1, keepdim=True) + EPS)
    per_anchor = (factor * (1.0 - torch.exp(-e)) * kpt_vis).mean(-1)
    kobj = sigmoid_bce(kr[..., 2], kpt_vis).mean(-1)
    sums["pose"] = (per_anchor * sel_fg).sum()
    sums["kobj"] = (kobj * sel_fg).sum()
    counts["kpt_fg"] = sel_fg.sum()
    return sums, counts, {"num_fg": t["fg"].sum()}


def pose_total(sums: Dict, counts: Dict, nc: int):
    """The detection terms plus 12 × the keypoint and 1 × the visibility
    sum over the selected foreground anchors (at least 1)."""
    total, parts = detection_total(sums, counts, nc)
    fg_n = counts["kpt_fg"].clamp(min=1.0)
    loss_pose = sums["pose"] / fg_n
    loss_kobj = sums["kobj"] / fg_n
    return total + 12.0 * loss_pose + 1.0 * loss_kobj, \
        dict(parts, pose=loss_pose, kobj=loss_kobj)


pose_loss = Objective(pose_parts, pose_total)


def make_train_step_pose(lr: float = 1e-3, clip_norm: float = 10.0):
    """``make_train_step_pose`` :135: the v8 step with gt keypoints last."""
    return make_train_step(pose_loss, lr, clip_norm)
