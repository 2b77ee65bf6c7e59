"""Test-time augmentation, ultralytics ``predict(augment=True)`` — the
port of ``roadvision_tpu/ops/tta.py``.

Three forwards at scales 1 / 0.83 / 0.67, the second mirrored; each
canvas resized bilinearly (half-pixel, no antialias) and padded
bottom-right to a stride-32 multiple with 0.447; boxes mapped back to
the base canvas; the full-scale pass's stride-32 level and the smallest
pass's stride-8 level trimmed (:func:`clip_bounds`). The detector puts
all candidates into one NMS with ``pre_topk`` 600
(``YOLOTorch.postprocess``), as ``tta_nms`` does in the JAX package.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .letterbox import resize_linear

TTA_SCALES: Tuple[float, ...] = (1.0, 0.83, 0.67)
TTA_HFLIP: Tuple[bool, ...] = (False, True, False)
_PAD_VALUE = 0.447  # imagenet-mean gray, the ultralytics scale_img fill
_NL = 3             # detection levels (strides 8/16/32)


def scale_img(x: torch.Tensor, ratio: float, gs: int = 32) -> torch.Tensor:
    """(B, H, W, C) float canvas → resized by ``ratio``, padded
    bottom / right to a ``gs`` multiple with 0.447."""
    if ratio == 1.0:
        return x
    h, w = x.shape[1], x.shape[2]
    sh, sw = int(h * ratio), int(w * ratio)
    y = resize_linear(x, sh, sw)
    ph = math.ceil(h * ratio / gs) * gs - sh
    pw = math.ceil(w * ratio / gs) * gs - sw
    return F.pad(y, (0, 0, 0, pw, 0, ph), value=_PAD_VALUE)


def clip_bounds(n_anchors: int, aug_index: int, n_augs: int,
                nl: int = _NL) -> Tuple[int, int]:
    """Kept anchor range [start, stop) of one augmentation (ultralytics
    ``_clip_augmented``): the first pass drops its stride-32 level, the
    last its stride-8 level; exact on stride-32 canvases."""
    g = sum(4 ** k for k in range(nl))
    start, stop = 0, n_anchors
    if aug_index == 0:
        stop = n_anchors - n_anchors // g
    if aug_index == n_augs - 1:
        start = (n_anchors // g) * 4 ** (nl - 1)
    return start, stop


def tta_candidates(fwd, imgs: torch.Tensor):
    """``fwd(imgs) -> (boxes, scores)`` over the three augmented canvases
    → (boxes (B, N', 4) in the base canvas' pixels, scores (B, N', nc)),
    trimmed by :func:`clip_bounds`."""
    w_base = imgs.shape[2]
    boxes_out, scores_out = [], []
    for i, (s, hflip) in enumerate(zip(TTA_SCALES, TTA_HFLIP)):
        xi = scale_img(imgs.flip(2) if hflip else imgs, s)
        boxes, scores = fwd(xi)
        boxes = boxes / s
        if hflip:
            boxes = torch.cat([w_base - boxes[..., 2:3], boxes[..., 1:2],
                               w_base - boxes[..., 0:1], boxes[..., 3:4]],
                              dim=-1)
        start, stop = clip_bounds(boxes.shape[1], i, len(TTA_SCALES))
        boxes_out.append(boxes[:, start:stop])
        scores_out.append(scores[:, start:stop])
    return torch.cat(boxes_out, dim=1), torch.cat(scores_out, dim=1)

