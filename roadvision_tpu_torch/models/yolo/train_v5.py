"""YOLOv5 training — the port of ``roadvision_tpu/models/yolo/train_v5.py``.

The v5 (v6.0) objective with fixed shapes, as in the JAX package: per
level a gt goes to each anchor whose size ratio is under 4 and to up to
three grid cells (its centre cell and the two neighbours the ±0.5 rule
picks), held as a dense (B, M, A, 5) mask; CIoU on the positives with the
v5 decode, objectness BCE over every anchor against the detached clamped
CIoU scattered by maximum (per-level balance 4.0 / 1.0 / 0.4), class BCE
on the positives; gains 0.05 / 1.0 / 0.5 · nc / 80, the sum times the
batch size. The objectness target is ``scatter_reduce("amax")`` into a
buffer one slot longer than the grid, the slot that takes the masked-out
positives dropped (JAX's ``.at[…].max(mode="drop")``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .train import (Objective, ciou, device_constant, init_momentum,
                    make_train_step, sigmoid_bce, timed)
from .yolov5 import ANCHORS, NUM_ANCHORS, STRIDES

ANCHOR_T = 4.0
BALANCE = (4.0, 1.0, 0.4)
# candidate cell offsets: centre, left, up, right, down (grid units)
_OFFSETS = ((0, 0), (-1, 0), (0, -1), (1, 0), (0, 1))
G = 0.5  # neighbour-cell reach


def _level_targets(gt_boxes, gt_mask, anchors_grid, hw):
    """``_level_targets`` :45. gt_boxes (B, M, 4) xyxy in this level's
    grid units; anchors_grid (A, 2). → (mask (B, M, A, 5), cell_x, cell_y
    (B, M, 5) int64, txy (B, M, A, 5, 2), twh (B, M, A, 5, 2))."""
    h, w = hw
    cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) * 0.5
    cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) * 0.5
    gw = gt_boxes[..., 2] - gt_boxes[..., 0]
    gh = gt_boxes[..., 3] - gt_boxes[..., 1]
    gxy = torch.stack([cx, cy], -1)
    gwh = torch.stack([gw, gh], -1)

    r = gwh[:, :, None, :] / anchors_grid[None, None, :, :]
    ratio_ok = torch.maximum(r, 1.0 / r.clamp(min=1e-9)).amax(-1) < ANCHOR_T
    ratio_ok = ratio_ok & gt_mask[..., None] \
        & (gwh.amin(-1) > 0)[..., None]

    gx, gy = gxy[..., 0], gxy[..., 1]
    fx, fy = torch.remainder(gx, 1.0), torch.remainder(gy, 1.0)
    cand_ok = torch.stack([
        torch.ones_like(fx, dtype=torch.bool),
        (fx < G) & (gx > 1.0),
        (fy < G) & (gy > 1.0),
        (fx > 1.0 - G) & (gx < w - 1.0),
        (fy > 1.0 - G) & (gy < h - 1.0),
    ], dim=-1)

    offs = device_constant("v5_offsets", _OFFSETS, gxy.device)
    cell = torch.floor(gxy[:, :, None, :] + offs[None, None] * G).long()
    cell_x = cell[..., 0].clamp(0, w - 1)
    cell_y = cell[..., 1].clamp(0, h - 1)

    mask = ratio_ok[:, :, :, None] & cand_ok[:, :, None, :]
    txy = gxy[:, :, None, None, :] \
        - torch.stack([cell_x, cell_y], -1)[:, :, None].float()
    txy = txy.expand(mask.shape + (2,))
    twh = gwh[:, :, None, None, :].expand(mask.shape + (2,))
    return mask, cell_x, cell_y, txy, twh


def v5_parts(model: nn.Module, images: torch.Tensor,
             gt_boxes: torch.Tensor, gt_cls: torch.Tensor,
             gt_mask: torch.Tensor):
    """The :class:`~.train.Objective` parts of ``detection_loss_v5`` :92
    for a YOLOv5 model (the v8 loss's arguments): per level the box,
    objectness and class sums, the positives and the objectness cells
    they are divided by, and the batch size the sum is scaled by."""
    nc = model.nc
    _, raws = model.features_and_head(images)     # 3 × (B, A·(5+nc), h, w)
    bsz = gt_cls.shape[0]
    a = NUM_ANCHORS
    dev = images.device
    sums: Dict[str, torch.Tensor] = {}
    counts: Dict[str, object] = {"images": bsz}
    num_pos = torch.zeros((), dtype=torch.int64, device=dev)

    for lvl, raw in enumerate(raws):
        _, _, h, w = raw.shape
        stride = float(STRIDES[lvl])
        raw = raw.permute(0, 2, 3, 1).reshape(bsz, h, w, a, 5 + nc)
        anchors_grid = device_constant("v5_anchors", ANCHORS, dev)[lvl] \
            / stride

        with timed("assign"):
            mask, cell_x, cell_y, txy, twh = _level_targets(
                gt_boxes / stride, gt_mask, anchors_grid, (h, w))
            shape = mask.shape
            bidx = torch.arange(bsz, device=dev)[:, None, None, None] \
                .expand(shape)
            aidx = torch.arange(a, device=dev)[None, None, :, None] \
                .expand(shape)
            cxb = cell_x[:, :, None, :].expand(shape)
            cyb = cell_y[:, :, None, :].expand(shape)
            flat = (((bidx * h + cyb) * w + cxb) * a + aidx).reshape(-1)
            pmask = mask.reshape(-1)
        preds = raw.reshape(-1, 5 + nc)[flat]

        sig = torch.sigmoid(preds)
        pxy = sig[:, 0:2] * 2.0 - 0.5
        pwh = (sig[:, 2:4] * 2.0) ** 2 * anchors_grid[aidx.reshape(-1)]
        cellf = torch.stack([cxb.reshape(-1), cyb.reshape(-1)], -1).float()
        pred_box = torch.cat([pxy + cellf - pwh / 2, pxy + cellf + pwh / 2],
                             -1)
        tcen = txy.reshape(-1, 2) + cellf
        twh_f = twh.reshape(-1, 2)
        tgt_box = torch.cat([tcen - twh_f / 2, tcen + twh_f / 2], -1)

        iou = ciou(pred_box, tgt_box)
        zero = torch.zeros_like(iou)
        sums[f"box{lvl}"] = torch.where(pmask, 1.0 - iou, zero).sum()
        counts[f"pos{lvl}"] = pmask.sum()

        # objectness target: the detached clamped CIoU, scatter-max into
        # the grid; masked-out positives land in the extra slot, dropped
        n_slots = bsz * h * w * a
        iou_d = torch.where(pmask, iou.detach().clamp(min=0.0), zero)
        slot = torch.where(pmask, flat, torch.full_like(flat, n_slots))
        tobj = torch.zeros(n_slots + 1, dtype=torch.float32, device=dev) \
            .scatter_reduce(0, slot, iou_d, "amax")[:n_slots]
        obj_logits = raw[..., 4].reshape(-1)
        sums[f"obj{lvl}"] = sigmoid_bce(obj_logits, tobj).sum()
        counts[f"cells{lvl}"] = obj_logits.numel()

        if nc > 1:
            tcls = gt_cls.long()[:, :, None, None].expand(shape).reshape(-1)
            onehot = F.one_hot(tcls.clamp(0, nc - 1), nc).float()
            bce = sigmoid_bce(preds[:, 5:], onehot).sum(-1)
            sums[f"cls{lvl}"] = torch.where(pmask, bce, zero).sum()
        num_pos = num_pos + pmask.sum()
    return sums, counts, {"num_fg": num_pos}


def v5_total(sums: Dict, counts: Dict, nc: int):
    """``detection_loss_v5``'s combination: per level the box and class
    sums over its positives (at least 1; the class sum also over nc), the
    objectness sum over its cells times the level's balance; gains 0.05 /
    1.0 / 0.5 · nc / 80, the sum times the batch size."""
    loss_box = loss_obj = loss_cls = 0.0
    for lvl, balance in enumerate(BALANCE):
        n_pos = counts[f"pos{lvl}"].clamp(min=1).float()
        loss_box = loss_box + sums[f"box{lvl}"] / n_pos
        loss_obj = loss_obj + balance * (sums[f"obj{lvl}"]
                                         / counts[f"cells{lvl}"])
        if nc > 1:
            loss_cls = loss_cls + sums[f"cls{lvl}"] / (n_pos * nc)
    total = (0.05 * loss_box + 1.0 * loss_obj
             + 0.5 * nc / 80.0 * loss_cls) * counts["images"]
    return total, {"box": loss_box, "obj": loss_obj, "cls": loss_cls}


detection_loss_v5 = Objective(v5_parts, v5_total)


def make_train_step_v5(lr: float = 1e-3, clip_norm: float = 10.0):
    """``make_train_step_v5`` :174: the v8 step on the v5 objective."""
    return make_train_step(detection_loss_v5, lr, clip_norm)


__all__ = ["detection_loss_v5", "make_train_step_v5", "init_momentum"]
