"""YOLOv8-seg / YOLO11-seg training — the port of
``roadvision_tpu/models/yolo/train_seg.py``.

The detection terms of ``train.py`` plus the prototype mask term: for the
top-K foreground anchors by assignment weight (K = 64), BCE between the
instance mask (coefficients · prototypes, at input/4) and the gt mask,
cropped to the gt box and normalised by its area; gain 7.5. The top K is
:func:`models.rtdetr.topk_stable` — descending, equal weights in index
order — so the anchors picked are ``lax.top_k``'s. Gt masks come at
prototype resolution (B, M, H/4, W/4).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..rtdetr import topk_stable
from .train import (Objective, detection_terms, detection_total,
                    make_train_step, sigmoid_bce)
from .yolov8 import run_branch


def top_foreground(weight: torch.Tensor, k: int):
    """(values (B, K), indices (B, K)) of the K largest assignment
    weights, ties in index order."""
    idx = topk_stable(weight, min(int(k), weight.shape[1]))
    return torch.gather(weight, 1, idx), idx


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, ...) rows at (B, K) indices → (B, K, ...)."""
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(shape))


def head_rows(model: nn.Module, feats) -> torch.Tensor:
    """The task branch ``cv4`` of every level → (B, N, C) per anchor."""
    head = model.layers[model.head_key]
    return torch.cat([run_branch(head.cv4[lvl], f).flatten(2)
                      for lvl, f in enumerate(feats)], dim=2).transpose(1, 2)


def seg_parts(model: nn.Module, images, gt_boxes, gt_cls, gt_mask,
              gt_masks, mask_topk: int = 64):
    """The :class:`~.train.Objective` parts of ``segmentation_loss`` :39;
    gt_masks (B, M, H/4, W/4) float. Adds the mask term's sum over the
    selected foreground anchors and their count."""
    feats, outs = model.features_and_head(images)
    coeffs = head_rows(model, feats)                         # (B, N, nm)
    protos = model.layers[model.head_key].proto(feats[0])    # (B, nm, h, w)
    sums, counts, t = detection_terms(outs, model.nc, gt_boxes, gt_cls,
                                      gt_mask)

    sel_w, sel_idx = top_foreground(t["weight"], mask_topk)
    sel_fg = sel_w > 0
    kc = gather_rows(coeffs, sel_idx)
    kgt = torch.gather(t["target_gt"], 1, sel_idx)
    kboxes = gather_rows(t["target_boxes"], sel_idx) / 4.0   # proto px
    tmasks = gather_rows(gt_masks, kgt)                      # (B, K, h, w)

    mlogits = torch.einsum("bkn,bnhw->bkhw", kc.float(), protos.float())
    mbce = sigmoid_bce(mlogits, tmasks.float())
    mh, mw = mlogits.shape[2], mlogits.shape[3]
    dev = mlogits.device
    col = torch.arange(mw, dtype=torch.float32, device=dev)[None, None, None]
    row = torch.arange(mh, dtype=torch.float32,
                       device=dev)[None, None, :, None]
    inside = ((col >= kboxes[..., 0][..., None, None])
              & (col < kboxes[..., 2][..., None, None])
              & (row >= kboxes[..., 1][..., None, None])
              & (row < kboxes[..., 3][..., None, None]))
    area = ((kboxes[..., 2] - kboxes[..., 0])
            * (kboxes[..., 3] - kboxes[..., 1])).clamp(min=1.0)
    per_anchor = (mbce * inside).sum((-2, -1)) / area
    sums["mask"] = (per_anchor * sel_fg).sum()
    counts["mask_fg"] = sel_fg.sum()
    return sums, counts, {"num_fg": t["fg"].sum()}


def seg_total(sums: Dict, counts: Dict, nc: int):
    """The detection terms plus 7.5 × the mask sum over the selected
    foreground anchors (at least 1)."""
    total, parts = detection_total(sums, counts, nc)
    loss_mask = sums["mask"] / counts["mask_fg"].clamp(min=1.0)
    return total + 7.5 * loss_mask, dict(parts, mask=loss_mask)


segmentation_loss = Objective(seg_parts, seg_total)


def make_train_step_seg(lr: float = 1e-3, clip_norm: float = 10.0):
    """``make_train_step_seg`` :134: the v8 step with gt masks last."""
    return make_train_step(segmentation_loss, lr, clip_norm)
