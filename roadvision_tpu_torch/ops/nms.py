"""Fixed-shape class-aware greedy NMS — the port of
``roadvision_tpu/ops/nms.py:35-124``.

Semantics kept: candidate iff max class score > conf_thres (strict);
top ``pre_topk`` by score with first-index ties (``lax.top_k``); classes
separated by the ``MAX_WH`` = 7680 coordinate offset; suppress when
IoU > iou_thres (strict); score-descending stable compaction; cap at
``max_det``; ``classes_keep`` applied AFTER max_det, as the reference's
post-predict filter does.

The greedy keep-mask is the JAX package's Jacobi fixpoint (``keep ←
valid & ¬∃ j<i: keep_j ∧ iou(j,i) > t`` until unchanged), batched over
frames. JAX runs it as a device ``while_loop``; here each round reads
one flag back to the host (one sync per round, typically 2-4 rounds a
batch) — the price of a data-dependent loop in eager PyTorch.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

MAX_WH = 7680.0


def iou_matrix_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) → (..., K, K) pairwise IoU; degenerate unions → 0."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0.0) * (y2 - y1).clamp(min=0.0)
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :])).clamp(min=0.0)
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :])).clamp(min=0.0)
    inter = iw * ih
    union = area[..., :, None] + area[..., None, :] - inter
    ok = union > 0
    return torch.where(ok, inter / torch.where(ok, union,
                                               torch.ones_like(union)),
                       torch.zeros_like(union))


def nms_batch(boxes: torch.Tensor, scores: torch.Tensor,
              conf_thres: float = 0.25, iou_thres: float = 0.7,
              max_det: int = 100, pre_topk: int = 300,
              classes_keep: Optional[Sequence[int]] = None):
    """boxes (B, N, 4) xyxy, scores (B, N, nc) → (boxes (B, M, 4),
    conf (B, M), cls (B, M) int32, valid (B, M) bool), M = min(max_det,
    pre_topk, N), score-descending."""
    bsz, n, _ = boxes.shape
    conf = scores.max(dim=-1).values
    cls = scores.argmax(dim=-1).to(torch.int32)
    masked = torch.where(conf > conf_thres, conf, torch.full_like(conf, -1.0))
    k = min(pre_topk, n)
    sel_scores, sel_idx = torch.sort(masked, dim=1, descending=True,
                                     stable=True)
    sel_scores, sel_idx = sel_scores[:, :k], sel_idx[:, :k]
    sel_boxes = torch.gather(boxes, 1, sel_idx[..., None].expand(bsz, k, 4))
    sel_cls = torch.gather(cls, 1, sel_idx)
    sel_valid = sel_scores > 0.0

    offset = sel_cls.to(torch.float32)[..., None] * MAX_WH
    iou = iou_matrix_xyxy(sel_boxes + offset)
    ar = torch.arange(k, device=boxes.device)
    lower = ar[:, None] < ar[None, :]
    suppress = (iou > iou_thres) & lower \
        & sel_valid[:, :, None] & sel_valid[:, None, :]

    keep = sel_valid
    for _ in range(k + 1):   # converges in (longest chain + 1) rounds
        new = sel_valid & ~(suppress & keep[:, :, None]).any(dim=1)
        if torch.equal(new, keep):
            break
        keep = new

    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    order = order[:, :max_det]
    m = order.shape[1]
    kept_boxes = torch.gather(sel_boxes, 1, order[..., None].expand(bsz, m, 4))
    kept_conf = torch.gather(sel_scores, 1, order)
    kept_cls = torch.gather(sel_cls, 1, order)
    kept_valid = torch.gather(keep, 1, order)
    if classes_keep:
        allowed = torch.zeros(scores.shape[-1], dtype=torch.bool,
                              device=boxes.device)
        allowed[list(int(c) for c in classes_keep)] = True
        kept_valid = kept_valid & allowed[kept_cls.long()]
    return kept_boxes, kept_conf, kept_cls, kept_valid


def nms_single(boxes: torch.Tensor, scores: torch.Tensor, **kw):
    """One image: boxes (N, 4), scores (N, nc) → per-image outputs."""
    return tuple(t[0] for t in nms_batch(boxes[None], scores[None], **kw))
