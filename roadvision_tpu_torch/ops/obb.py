"""Rotated-box geometry and the rotated NMS — the port of
``roadvision_tpu/ops/obb.py``.

Overlap is ProbIoU (each box (cx, cy, w, h, θ) a Gaussian with
covariance diag(w²/12, h²/12) rotated by θ; 1 − the Hellinger distance
of two of them), closed form and elementwise. The NMS is
``ops/nms.py::nms_batch`` with the ProbIoU matrix in place of the IoU
one: candidates by score, class offsets on the centres, the exact greedy
keep mask by the Jacobi fixpoint (``nms_rotated_single``,
obb.py:108-165, batched over frames as ``nms_rotated_batch``), one host
sync per round.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .nms import MAX_WH, compact, greedy_keep, select_candidates

_EPS = 1e-7


def rbox_covariance(rb: torch.Tensor):
    """(..., 5) → (a, b, c) of the rotated covariance [[a, c], [c, b]]."""
    a = rb[..., 2] ** 2 / 12.0
    b = rb[..., 3] ** 2 / 12.0
    cos, sin = torch.cos(rb[..., 4]), torch.sin(rb[..., 4])
    return (a * cos ** 2 + b * sin ** 2, a * sin ** 2 + b * cos ** 2,
            (a - b) * cos * sin)


def probiou_pairs(rb1: torch.Tensor, rb2: torch.Tensor) -> torch.Tensor:
    """Elementwise (broadcastable) ProbIoU of (..., 5) rboxes."""
    x1, y1 = rb1[..., 0], rb1[..., 1]
    x2, y2 = rb2[..., 0], rb2[..., 1]
    a1, b1, c1 = rbox_covariance(rb1)
    a2, b2, c2 = rbox_covariance(rb2)
    den = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) \
        / (den + _EPS) * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / (den + _EPS) * 0.5
    det1 = torch.clamp(a1 * b1 - c1 ** 2, min=0.0)
    det2 = torch.clamp(a2 * b2 - c2 ** 2, min=0.0)
    t3 = torch.log(den / (4.0 * torch.sqrt(det1 * det2) + _EPS) + _EPS) * 0.5
    bd = torch.clamp(t1 + t2 + t3, _EPS, 100.0)
    return 1.0 - torch.sqrt(1.0 - torch.exp(-bd) + _EPS)


def probiou_matrix(rb: torch.Tensor) -> torch.Tensor:
    """(..., K, 5) → (..., K, K) pairwise ProbIoU."""
    return probiou_pairs(rb[..., :, None, :], rb[..., None, :, :])


def rbox_corners(rb: torch.Tensor) -> torch.Tensor:
    """(..., 5) → (..., 4, 2) corners (+w+h, +w−h, −w−h, −w+h)."""
    cx, cy, w, h, th = rb.unbind(-1)
    cos, sin = torch.cos(th)[..., None], torch.sin(th)[..., None]
    dx = torch.stack([w, w, -w, -w], dim=-1) / 2.0
    dy = torch.stack([h, -h, -h, h], dim=-1) / 2.0
    return torch.stack([cx[..., None] + dx * cos - dy * sin,
                        cy[..., None] + dx * sin + dy * cos], dim=-1)


def rbox_to_aabb(rb: torch.Tensor) -> torch.Tensor:
    """(..., 5) → (..., 4) enclosing axis-aligned xyxy."""
    c = rbox_corners(rb)
    return torch.cat([c.min(dim=-2).values, c.max(dim=-2).values], dim=-1)


def scale_rboxes(rb: torch.Tensor, ratio, pad, orig_hw) -> torch.Tensor:
    """Letterbox-space rboxes → source pixels: centre un-padded,
    un-scaled and clamped into the frame, size un-scaled, θ unchanged."""
    h, w = orig_hw
    cx = ((rb[..., 0] - pad[0]) / ratio).clamp(0, w)
    cy = ((rb[..., 1] - pad[1]) / ratio).clamp(0, h)
    return torch.stack([cx, cy, rb[..., 2] / ratio, rb[..., 3] / ratio,
                        rb[..., 4]], dim=-1)


def nms_rotated_batch(rboxes: torch.Tensor, scores: torch.Tensor,
                      conf_thres: float = 0.25, iou_thres: float = 0.7,
                      max_det: int = 100, pre_topk: int = 300,
                      classes_keep: Optional[Sequence[int]] = None,
                      return_idx: bool = False):
    """rboxes (B, N, 5), scores (B, N, nc) → (rboxes (B, M, 5), conf,
    cls int32, valid[, source anchor index]), M = min(max_det, pre_topk,
    N), score-descending, exact-greedy ProbIoU suppression, class-aware
    by centre offsets, ``classes_keep`` after the cap."""
    sel_scores, sel_idx, sel_cls, sel_valid = select_candidates(
        scores, conf_thres, pre_topk)
    k = sel_idx.shape[1]
    sel_rb = torch.gather(rboxes, 1, sel_idx[..., None].expand(-1, k, 5))
    offset = sel_cls.to(torch.float32)[..., None] * MAX_WH
    shifted = torch.cat([sel_rb[..., :2] + offset, sel_rb[..., 2:]], dim=-1)
    keep = greedy_keep(probiou_matrix(shifted) > iou_thres, sel_valid)
    out = compact(keep, sel_rb, sel_scores, sel_cls, sel_idx, max_det,
                  scores.shape[-1], classes_keep)
    return out if return_idx else out[:4]


def nms_rotated_single(rboxes: torch.Tensor, scores: torch.Tensor, **kw):
    """One image: rboxes (N, 5), scores (N, nc) → per-image outputs."""
    return tuple(t[0] for t in nms_rotated_batch(rboxes[None], scores[None],
                                                 **kw))

