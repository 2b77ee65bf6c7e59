"""Fixed-shape class-aware greedy NMS — the port of
``roadvision_tpu/ops/nms.py`` (``nms_single`` / ``nms_batch`` with
``return_idx``, and the NMS-free ``select_topk_batch``).

Semantics kept: candidate iff max class score > conf_thres (strict);
top ``pre_topk`` by score with first-index ties (``lax.top_k``); classes
separated by the ``MAX_WH`` = 7680 coordinate offset; suppress when
IoU > iou_thres (strict); score-descending stable compaction; cap at
``max_det``; ``classes_keep`` applied AFTER max_det, as the reference's
post-predict filter does.

The greedy keep-mask: JAX runs its Jacobi fixpoint (``keep ← valid &
¬∃ j<i: keep_j ∧ iou(j,i) > t`` until unchanged) as a device
``while_loop``. On the card K6 ``nms_keep`` (``csrc/nms.cu``: the
sequential greedy, which has the same fixpoint, one block a frame, no
host read) computes it; on the CPU the plain fixpoint
:func:`greedy_keep_plain` does, reading one flag back to the host per
round (typically 2-4 rounds a batch). :func:`nms_batch` calls
:func:`greedy_keep_boxes`, K6's boxes mode: one launch computes what
nms.py:80-99 computes (the class offset, :func:`iou_matrix_xyxy`,
``> iou_thres``, the keep) in this module's arithmetic, so no (k, k)
matrix is made on the card. :func:`greedy_keep` (matrix mode) takes the
overlap booleans of a caller that tests overlap its own way: the rotated
NMS of ``ops/obb.py``, whose probabilistic IoU stays in torch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..kernels import _build
from ..utils.device import device_constant

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


def select_candidates(scores: torch.Tensor, conf_thres: float,
                      pre_topk: int):
    """scores (B, N, nc) → the top ``pre_topk`` anchors by best class
    score, candidates (score > conf_thres) first, equal scores by index:
    (scores, anchor index, class int32, valid), each (B, k)."""
    n = scores.shape[1]
    conf = scores.max(dim=-1).values
    cls = scores.argmax(dim=-1).to(torch.int32)
    masked = torch.where(conf > conf_thres, conf, torch.full_like(conf, -1.0))
    k = min(pre_topk, n)
    sel_scores, sel_idx = torch.sort(masked, dim=1, descending=True,
                                     stable=True)
    sel_scores, sel_idx = sel_scores[:, :k], sel_idx[:, :k]
    return sel_scores, sel_idx, torch.gather(cls, 1, sel_idx), sel_scores > 0.0


def greedy_keep_plain(over: torch.Tensor,
                      sel_valid: torch.Tensor) -> torch.Tensor:
    """The exact greedy keep mask over score-sorted candidates: ``over``
    (B, k, k) says which pairs overlap past the threshold; a candidate is
    kept unless an earlier kept one overlaps it. The Jacobi fixpoint,
    one host sync per round."""
    k = sel_valid.shape[1]
    ar = torch.arange(k, device=sel_valid.device)
    suppress = over & (ar[:, None] < ar[None, :]) \
        & sel_valid[:, :, None] & sel_valid[:, None, :]
    keep = sel_valid
    for _ in range(k + 1):   # converges in (longest chain + 1) rounds
        new = sel_valid & ~(suppress & keep[:, :, None]).any(dim=1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


# K6 handles up to 1024 candidates a frame (one warp holds the
# suppressed set, a 32-bit word a lane)
KEEP_MAX_K = 1024


def _keep_cuda(over: torch.Tensor, sel_valid: torch.Tensor) -> torch.Tensor:
    bsz, k = sel_valid.shape
    keep = torch.empty((bsz, k), dtype=torch.bool, device=over.device)
    # the overlap rows packed to bits, one 32-bit word a 32 columns
    packed = torch.empty((bsz, k, -(-k // 32)), dtype=torch.int32,
                         device=over.device)
    ov = over.contiguous().view(torch.uint8)
    valid = sel_valid.contiguous().view(torch.uint8)
    lib = _build.load("nms")
    with torch.cuda.device(over.device):
        code = lib.rvt_nms_keep(ov.data_ptr(), valid.data_ptr(),
                                keep.data_ptr(), packed.data_ptr(), bsz, k,
                                _build.stream_ptr(over))
    _build.launch_counts["nms_keep"] += 1
    _build.check(code, "nms_keep")
    return keep


def _check_frames(bsz: int, k: int) -> None:
    if bsz < 1 or k < 1 or k > KEEP_MAX_K or bsz > 2 ** 31 - 1:
        raise ValueError(f"nms_keep takes 1..{KEEP_MAX_K} candidates and "
                         f"at least one frame, got ({bsz}, {k})")


def greedy_keep(over: torch.Tensor, sel_valid: torch.Tensor) -> torch.Tensor:
    """K6 wrapper: the greedy keep mask (B, k) bool of ``over`` (B, k, k)
    bool and ``sel_valid`` (B, k) bool. A CPU tensor runs
    :func:`greedy_keep_plain`; a CUDA tensor launches the kernel, one
    block per frame, on the current stream."""
    if over.dtype != torch.bool or sel_valid.dtype != torch.bool \
            or over.dim() != 3 or sel_valid.dim() != 2 \
            or over.shape != sel_valid.shape + sel_valid.shape[-1:]:
        raise ValueError(f"expected over (B, k, k) and sel_valid (B, k) "
                         f"bool, got {tuple(over.shape)} {over.dtype} and "
                         f"{tuple(sel_valid.shape)} {sel_valid.dtype}")
    if over.device.type == "cpu":
        return greedy_keep_plain(over, sel_valid)
    if over.device.type != "cuda" or sel_valid.device != over.device:
        raise ValueError(f"unsupported devices {over.device}, "
                         f"{sel_valid.device}")
    _check_frames(*sel_valid.shape)
    return _keep_cuda(over, sel_valid)


def greedy_keep_boxes_plain(sel_boxes: torch.Tensor, sel_cls: torch.Tensor,
                            sel_valid: torch.Tensor,
                            iou_thres: float) -> torch.Tensor:
    """What nms.py:80-99 computes for score-sorted candidates: boxes
    (B, k, 4) offset by class (``cls · MAX_WH``), their pairwise IoU,
    ``> iou_thres``, the greedy keep mask (B, k) bool."""
    offset = sel_cls.to(torch.float32)[..., None] * MAX_WH
    return greedy_keep_plain(iou_matrix_xyxy(sel_boxes + offset) > iou_thres,
                             sel_valid)


def _keep_boxes_cuda(sel_boxes, sel_cls, sel_valid, iou_thres: float):
    bsz, k = sel_valid.shape
    dev = sel_boxes.device
    keep = torch.empty((bsz, k), dtype=torch.bool, device=dev)
    boxes = sel_boxes.contiguous()
    cls = sel_cls.to(torch.int32).contiguous()
    valid = sel_valid.contiguous().view(torch.uint8)
    lib = _build.load("nms")
    with torch.cuda.device(dev):
        code = lib.rvt_nms_keep_boxes(
            boxes.data_ptr(), cls.data_ptr(), valid.data_ptr(),
            keep.data_ptr(), bsz, k, ctypes.c_float(float(iou_thres)),
            _build.stream_ptr(sel_boxes))
    _build.launch_counts["nms_keep"] += 1
    _build.check(code, "nms_keep")
    return keep


def greedy_keep_boxes(sel_boxes: torch.Tensor, sel_cls: torch.Tensor,
                      sel_valid: torch.Tensor,
                      iou_thres: float) -> torch.Tensor:
    """K6 in boxes mode: the greedy keep mask (B, k) bool of score-sorted
    candidates ``sel_boxes`` (B, k, 4) xyxy of classes ``sel_cls`` (B, k)
    and ``sel_valid`` (B, k) bool, suppressing where the class-offset IoU
    is > ``iou_thres``. A CPU tensor runs :func:`greedy_keep_boxes_plain`;
    a CUDA tensor launches the kernel, IoU included, one block per frame,
    on the current stream."""
    if sel_boxes.dim() != 3 or sel_boxes.shape[-1] != 4 \
            or sel_valid.dtype != torch.bool \
            or sel_valid.shape != sel_boxes.shape[:2] \
            or sel_cls.shape != sel_valid.shape:
        raise ValueError(f"expected sel_boxes (B, k, 4), sel_cls (B, k) and "
                         f"sel_valid (B, k) bool, got "
                         f"{tuple(sel_boxes.shape)}, {tuple(sel_cls.shape)} "
                         f"and {tuple(sel_valid.shape)} {sel_valid.dtype}")
    if sel_boxes.device.type == "cpu":
        return greedy_keep_boxes_plain(sel_boxes, sel_cls, sel_valid,
                                       iou_thres)
    if sel_boxes.device.type != "cuda" or sel_cls.device != sel_boxes.device \
            or sel_valid.device != sel_boxes.device:
        raise ValueError(f"unsupported devices {sel_boxes.device}, "
                         f"{sel_cls.device}, {sel_valid.device}")
    if sel_boxes.dtype != torch.float32 or sel_cls.is_floating_point():
        raise ValueError(f"nms_keep takes float32 boxes and integer "
                         f"classes, got {sel_boxes.dtype}, {sel_cls.dtype}")
    _check_frames(*sel_valid.shape)
    return _keep_boxes_cuda(sel_boxes, sel_cls, sel_valid, iou_thres)


def _allowed(nc: int, classes_keep: Sequence[int], device) -> torch.Tensor:
    """(nc,) bool, True for the ``classes_keep`` ids inside the model's
    classes: made once per (nc, ids, device), before any capture."""
    ids = {int(c) for c in classes_keep}
    return device_constant([c in ids for c in range(nc)], torch.bool,
                           device)


def compact(keep, sel_boxes, sel_scores, sel_cls, sel_idx, max_det: int,
            nc: int, classes_keep: Optional[Sequence[int]] = None):
    """Kept candidates first (stable), capped at ``max_det``, then
    ``classes_keep``: (boxes, conf, cls, valid, source anchor index)."""
    bsz, width = sel_boxes.shape[0], sel_boxes.shape[-1]
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    order = order[:, :max_det]
    m = order.shape[1]
    kept_boxes = torch.gather(sel_boxes, 1,
                              order[..., None].expand(bsz, m, width))
    kept_cls = torch.gather(sel_cls, 1, order)
    kept_valid = torch.gather(keep, 1, order)
    if classes_keep:
        # ids past the model's classes keep nothing (JAX drops the
        # out-of-range ``.at[].set``), e.g. [0, 2, 3, 5, 7] on a
        # one-class pose model
        kept_valid = kept_valid \
            & _allowed(nc, classes_keep, keep.device)[kept_cls.long()]
    return (kept_boxes, torch.gather(sel_scores, 1, order), kept_cls,
            kept_valid, torch.gather(sel_idx, 1, order).to(torch.int32))


def nms_batch(boxes: torch.Tensor, scores: torch.Tensor,
              conf_thres: float = 0.25, iou_thres: float = 0.7,
              max_det: int = 100, pre_topk: int = 300,
              classes_keep: Optional[Sequence[int]] = None,
              return_idx: bool = False):
    """boxes (B, N, 4) xyxy, scores (B, N, nc) → (boxes (B, M, 4),
    conf (B, M), cls (B, M) int32, valid (B, M) bool), M = min(max_det,
    pre_topk, N), score-descending. With ``return_idx`` a fifth output
    carries each kept entry's source anchor index (B, M) int32
    (arbitrary where not valid): the handle per-anchor side outputs are
    gathered with."""
    sel_scores, sel_idx, sel_cls, sel_valid = select_candidates(
        scores, conf_thres, pre_topk)
    k = sel_idx.shape[1]
    sel_boxes = torch.gather(boxes, 1, sel_idx[..., None].expand(-1, k, 4))
    keep = greedy_keep_boxes(sel_boxes, sel_cls, sel_valid, iou_thres)
    out = compact(keep, sel_boxes, sel_scores, sel_cls, sel_idx, max_det,
                  scores.shape[-1], classes_keep)
    return out if return_idx else out[:4]


def nms_single(boxes: torch.Tensor, scores: torch.Tensor, **kw):
    """One image: boxes (N, 4), scores (N, nc) → per-image outputs."""
    return tuple(t[0] for t in nms_batch(boxes[None], scores[None], **kw))


def select_topk_batch(boxes: torch.Tensor, scores: torch.Tensor,
                      conf_thres: float = 0.25, max_det: int = 100,
                      classes_keep: Optional[Sequence[int]] = None):
    """NMS-free selection for set-prediction detectors (RT-DETR): score
    threshold, ``classes_keep``, top-k; no IoU pass.

    boxes (B, N, 4), scores (B, N, nc) → fixed-shape (boxes (B, max_det,
    4), conf, cls int32, valid bool), score-descending. Equal scores
    keep the lower index first, as ``jax.lax.top_k`` does (a stable
    descending sort; ``torch.topk`` promises no order among equals).
    N < max_det pads with zeros and ``valid`` False."""
    bsz, n, _ = boxes.shape
    conf = scores.max(dim=-1).values
    cls = scores.argmax(dim=-1).to(torch.int32)
    valid = conf > conf_thres
    if classes_keep:
        valid = valid & _allowed(scores.shape[-1], classes_keep,
                                 boxes.device)[cls.long()]
    k = min(max_det, n)
    top_conf, top_idx = torch.sort(
        torch.where(valid, conf, torch.full_like(conf, -1.0)), dim=1,
        descending=True, stable=True)
    top_conf, top_idx = top_conf[:, :k], top_idx[:, :k]
    out_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(bsz, k, 4))
    out_cls = torch.gather(cls, 1, top_idx)
    out_valid = top_conf > 0.0
    top_conf = torch.where(out_valid, top_conf, torch.zeros_like(top_conf))
    if k < max_det:
        pad = max_det - k
        out_boxes = F.pad(out_boxes, (0, 0, 0, pad))
        top_conf = F.pad(top_conf, (0, pad))
        out_cls = F.pad(out_cls, (0, pad))
        out_valid = F.pad(out_valid, (0, pad))
    return out_boxes, top_conf, out_cls, out_valid
