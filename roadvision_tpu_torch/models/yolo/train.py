"""YOLOv8 / YOLO11 training — the port of
``roadvision_tpu/models/yolo/train.py``.

The objective is the JAX package's, term for term:

  * task-aligned assignment (:func:`task_aligned_assign`): per gt the
    metric cls^0.5 · CIoU^6 over the anchors whose centre lies inside the
    gt box, its top 10 kept, an anchor claimed by several gts going to
    the highest metric (first gt on ties, as ``jnp.argmax``); run on
    detached scores and boxes;
  * BCE on the class logits against the normalised aligned targets,
    CIoU on the foreground boxes and the distribution-focal loss on the
    ltrb bins (targets clipped to ``REG_MAX − 1 − 0.01``), weighted
    7.5 / 0.5 / 1.5.

Each family's loss is an :class:`Objective`: its terms' numerators and
the batch-global normalisers they are divided by (here the target score
sum) come apart, so that a data-parallel step divides every replica's
sums by the whole batch's counts, as XLA does under ``--dp``.

:func:`make_train_step` is the JAX step's SGD with momentum 0.9, the
global-norm clip ``min(1, clip / (‖g‖ + 1e-9))`` and the non-finite
guard that skips a batch without touching the momentum (``torch.where``,
never ``scale · g``: 0 · NaN is NaN). The model trains in float32 (the
JAX default ``dtype=jnp.float32``); its parameters are updated in place.
The optimiser state is a dict of tensors keyed by the parameter names;
``weights.tree_from_state_dict`` turns it into the JAX tree.

The step makes no host sync: loss and aux stay on the device until the
caller reads them. The optimiser runs as multi-tensor ``torch._foreach_*``
operations over all parameters, one ``torch.where`` per gradient for the
guard. :data:`PART_TIMER` (off unless set) times the parts
of a step on the host clock with a device synchronise around each.
"""
from __future__ import annotations

import contextlib
import math
import time
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .yolov8 import REG_MAX, anchor_points

EPS = 1e-9


# ---------------------------------------------------------------------------
# step timing (off by default: no synchronise on the training path)
# ---------------------------------------------------------------------------

class PartTimer:
    """Wall ms of the parts of a train step, the device synchronised
    before and after each part. Parts nest: ``assign`` lies inside
    ``forward_loss``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.ms: Dict[str, list] = defaultdict(list)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def part(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.ms[name].append((time.perf_counter() - t0) * 1e3)


PART_TIMER: Optional[PartTimer] = None


def timed(name: str):
    """The part ``name`` of the running step under :data:`PART_TIMER`;
    a no-op when no timer is set."""
    return PART_TIMER.part(name) if PART_TIMER is not None \
        else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# geometry and assignment
# ---------------------------------------------------------------------------

def ciou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Complete IoU between broadcastable (..., 4) xyxy boxes; the aspect
    weight ``alpha`` is detached (``stop_gradient``, train.py:59)."""
    x1 = torch.maximum(box1[..., 0], box2[..., 0])
    y1 = torch.maximum(box1[..., 1], box2[..., 1])
    x2 = torch.minimum(box1[..., 2], box2[..., 2])
    y2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    w1 = (box1[..., 2] - box1[..., 0]).clamp(min=0)
    h1 = (box1[..., 3] - box1[..., 1]).clamp(min=0)
    w2 = (box2[..., 2] - box2[..., 0]).clamp(min=0)
    h2 = (box2[..., 3] - box2[..., 1]).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter
    iou = inter / (union + EPS)
    cw = torch.maximum(box1[..., 2], box2[..., 2]) \
        - torch.minimum(box1[..., 0], box2[..., 0])
    ch = torch.maximum(box1[..., 3], box2[..., 3]) \
        - torch.minimum(box1[..., 1], box2[..., 1])
    c2 = cw * cw + ch * ch + EPS
    dx = (box1[..., 0] + box1[..., 2] - box2[..., 0] - box2[..., 2]) * 0.5
    dy = (box1[..., 1] + box1[..., 3] - box2[..., 1] - box2[..., 3]) * 0.5
    rho2 = dx * dx + dy * dy
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + EPS))
                              - torch.atan(w1 / (h1 + EPS))) ** 2
    alpha = (v / (v - iou + 1 + EPS)).detach()
    return iou - rho2 / c2 - alpha * v


def select_aligned(align: torch.Tensor, inside: torch.Tensor,
                   overlaps: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_cls: torch.Tensor, nc: int, topk: int = 10):
    """The selection shared by the axis-aligned and rotated assigners
    (train.py:100-122): top-k per gt, conflicts to the highest metric,
    normalised targets. align / inside / overlaps (B, M, N); gt_boxes
    (B, M, D). → (fg (B, N), target_gt (B, N) int64, target_scores
    (B, N, nc), target boxes (B, N, D))."""
    k = min(topk, align.shape[-1])
    kth = torch.topk(align, k, dim=-1).values[..., -1:]
    cand = inside & (align >= kth) & (align > 0)

    masked = torch.where(cand, align, torch.full_like(align, -1.0))
    best_val = masked.amax(dim=1)
    best_gt = masked.argmax(dim=1)              # the first max, as jnp's
    fg = best_val > 0

    target_gt = torch.where(fg, best_gt, torch.zeros_like(best_gt))
    tb = torch.gather(gt_boxes, 1, target_gt[..., None].expand(
        -1, -1, gt_boxes.shape[-1]))
    tc = torch.gather(gt_cls.long(), 1, target_gt)

    zero = torch.zeros_like(align)
    pos_align = torch.where(cand, align, zero)
    pos_overlap = torch.where(cand, overlaps, zero)
    max_align = pos_align.amax(dim=-1, keepdim=True)
    max_olap = pos_overlap.amax(dim=-1, keepdim=True)
    norm = pos_align * max_olap / (max_align + EPS)
    anchor_score = norm.amax(dim=1)                          # (B, N)
    onehot = F.one_hot(tc.clamp(0, nc - 1), nc).to(align.dtype)
    target_scores = onehot * (anchor_score * fg)[..., None]
    return fg, target_gt, target_scores, tb


def class_scores_at_gt(scores: torch.Tensor, gt_cls: torch.Tensor
                       ) -> torch.Tensor:
    """(B, N, nc) scores → (B, M, N): each gt's class column."""
    nc = scores.shape[-1]
    idx = gt_cls.long().clamp(0, nc - 1)[:, :, None].expand(
        -1, -1, scores.shape[1])
    return torch.gather(scores.transpose(1, 2), 1, idx)


def task_aligned_assign(scores: torch.Tensor, pred_boxes: torch.Tensor,
                        anchors: torch.Tensor, gt_boxes: torch.Tensor,
                        gt_cls: torch.Tensor, gt_mask: torch.Tensor,
                        topk: int = 10, alpha: float = 0.5,
                        beta: float = 6.0):
    """``task_aligned_assign`` :63. scores (B, N, nc) sigmoid; pred_boxes
    (B, N, 4) input px; anchors (N, 2) pixel centres; gt_boxes (B, M, 4);
    gt_cls (B, M); gt_mask (B, M) bool. → (fg (B, N), target_gt (B, N),
    target_scores (B, N, nc), target_boxes (B, N, 4))."""
    with timed("assign"):
        ax, ay = anchors[:, 0], anchors[:, 1]
        inside = ((ax[None, None, :] > gt_boxes[..., 0:1])
                  & (ax[None, None, :] < gt_boxes[..., 2:3])
                  & (ay[None, None, :] > gt_boxes[..., 1:2])
                  & (ay[None, None, :] < gt_boxes[..., 3:4]))
        inside = inside & gt_mask[..., None]
        overlaps = ciou(gt_boxes[:, :, None, :],
                        pred_boxes[:, None, :, :]).clamp(min=0.0)
        cls_score = class_scores_at_gt(scores, gt_cls)
        align = (cls_score ** alpha) * (overlaps ** beta)
        align = torch.where(inside, align, torch.zeros_like(align))
        return select_aligned(align, inside, overlaps, gt_boxes, gt_cls,
                              scores.shape[-1], topk)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax_sigmoid_bce`` :201: the numerically stable form."""
    return logits.clamp(min=0) - logits * labels \
        + torch.log1p(torch.exp(-logits.abs()))


# ---------------------------------------------------------------------------
# the objective
# ---------------------------------------------------------------------------

def head_logits(outs, nc: int):
    """Per-level NCHW head outputs → (box logits (B, N, 64), class logits
    (B, N, nc), anchor centres (N, 2) in grid units, strides (N,), level
    sizes), anchors in the NHWC reshape's (y, x) order."""
    hw = [(b.shape[2], b.shape[3]) for b, _ in outs]
    pts, strides = anchor_points(hw, outs[0][0].device)
    box = torch.cat([b.flatten(2) for b, _ in outs], 2).transpose(1, 2)
    cls = torch.cat([c.flatten(2) for _, c in outs], 2).transpose(1, 2)
    return box, cls, pts, strides, hw


def decode_boxes(box_logits: torch.Tensor, pts: torch.Tensor,
                 strides: torch.Tensor) -> torch.Tensor:
    """DFL logits → (B, N, 4) xyxy input px (train.py:153-158)."""
    bs = box_logits.shape[0]
    probs = box_logits.reshape(bs, -1, 4, REG_MAX).softmax(dim=-1)
    ltrb = (probs * torch.arange(REG_MAX, dtype=torch.float32,
                                 device=probs.device)).sum(dim=-1)
    x1y1 = (pts[None] - ltrb[..., :2]) * strides[None, :, None]
    x2y2 = (pts[None] + ltrb[..., 2:]) * strides[None, :, None]
    return torch.cat([x1y1, x2y2], dim=-1)


def dfl_sum(box_logits: torch.Tensor, t_ltrb: torch.Tensor,
            weight: torch.Tensor) -> torch.Tensor:
    """Distribution-focal loss of (B, N, 4) target distances in grid units
    (train.py:181-193), summed with the anchors' weights; the caller
    divides by the batch's score sum."""
    bs = box_logits.shape[0]
    t_ltrb = t_ltrb.clamp(0, REG_MAX - 1 - 0.01)
    tl = torch.floor(t_ltrb).long()
    tr = tl + 1
    wl = tr.float() - t_ltrb
    wr = 1.0 - wl
    logp = F.log_softmax(box_logits.reshape(bs, -1, 4, REG_MAX), dim=-1)
    ce_l = -torch.gather(logp, -1, tl[..., None])[..., 0]
    ce_r = -torch.gather(logp, -1, tr.clamp(0, REG_MAX - 1)[..., None])[..., 0]
    dfl = (ce_l * wl + ce_r * wr).mean(-1)
    return (dfl * weight).sum()


def detection_terms(outs, nc: int, gt_boxes, gt_cls, gt_mask):
    """The v8 / v11 detection terms on a head's outputs, shared by the
    detect, segment and pose objectives. → (sums: the box, cls and dfl
    terms summed over this batch; counts: the target score sum they are
    divided by; a dict of what the task terms read: fg, target_gt,
    target_boxes, weight, pts, strides)."""
    box_logits, cls_logits, pts, strides, _ = head_logits(outs, nc)
    pred_boxes = decode_boxes(box_logits, pts, strides)
    scores = torch.sigmoid(cls_logits)
    fg, target_gt, target_scores, target_boxes = task_aligned_assign(
        scores.detach(), pred_boxes.detach(), pts * strides[:, None],
        gt_boxes, gt_cls, gt_mask)

    weight = target_scores.sum(-1) * fg
    t_ltrb = torch.cat([
        pts[None] - target_boxes[..., :2] / strides[None, :, None],
        target_boxes[..., 2:] / strides[None, :, None] - pts[None],
    ], dim=-1)
    sums = {"box": ((1.0 - ciou(pred_boxes, target_boxes)) * weight).sum(),
            "cls": sigmoid_bce(cls_logits, target_scores).sum(),
            "dfl": dfl_sum(box_logits, t_ltrb, weight)}
    return sums, {"score_sum": target_scores.sum()}, dict(
        fg=fg, target_gt=target_gt, target_boxes=target_boxes,
        weight=weight, pts=pts, strides=strides)


def detection_total(sums: Dict, counts: Dict, nc: int):
    """``detection_loss``'s combination :125: each term over the batch's
    target score sum (at least 1), weighted 7.5 / 0.5 / 1.5."""
    score_sum = counts["score_sum"].clamp(min=1.0)
    loss_box = sums["box"] / score_sum
    loss_cls = sums["cls"] / score_sum
    loss_dfl = sums["dfl"] / score_sum
    total = 7.5 * loss_box + 0.5 * loss_cls + 1.5 * loss_dfl
    return total, {"box": loss_box, "cls": loss_cls, "dfl": loss_dfl}


class Objective:
    """A loss split where its batch-global normalisers enter, so that a
    data-parallel step (``parallel/data.py``) can take them from every
    replica before any backward. ``parts(model, *batch) → (sums, counts,
    aux)``: the terms' numerators summed over this batch
    (differentiable), the shares of the normalisers they are divided by
    (detached counts) and aux (counts such as ``num_fg``); sums, counts
    and aux add over replicas. ``total(sums, counts, nc) → (loss,
    components)``. Calling it is the loss of one batch on one device:
    ``objective(model, *batch) → (loss, aux)``."""

    def __init__(self, parts: Callable, total: Callable):
        self.parts, self.total = parts, total

    def __call__(self, model: nn.Module, *batch) -> Tuple[torch.Tensor,
                                                          Dict]:
        sums, counts, aux = self.parts(model, *batch)
        loss, components = self.total(sums, counts, model.nc)
        return loss, dict(components, **aux)


def detection_parts(model: nn.Module, images: torch.Tensor,
                    gt_boxes: torch.Tensor, gt_cls: torch.Tensor,
                    gt_mask: torch.Tensor):
    """The :class:`Objective` parts of ``detection_loss`` :125 for a
    YOLOv8 or YOLO11 model. images (B, H, W, 3) float [0, 1]; gt_boxes
    (B, M, 4) xyxy input px; gt_cls (B, M); gt_mask (B, M) bool."""
    _, outs = model.features_and_head(images)
    sums, counts, t = detection_terms(outs, model.nc, gt_boxes, gt_cls,
                                      gt_mask)
    return sums, counts, {"num_fg": t["fg"].sum()}


detection_loss = Objective(detection_parts, detection_total)


# ---------------------------------------------------------------------------
# optimisers
# ---------------------------------------------------------------------------

def by_device(tensors) -> Dict[torch.device, list]:
    """Indices of ``tensors`` grouped by device, in first-seen order."""
    out: Dict[torch.device, list] = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.device, []).append(i)
    return out


def global_norm(grads, device: Optional[torch.device] = None
                ) -> torch.Tensor:
    """‖g‖ over every gradient, on ``device`` (the first gradient's by
    default): the norm of each device's norm, so that gradients spread
    over several cards need no copy of their own."""
    norms = [torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [grads[i] for i in idx]))) for idx in by_device(grads).values()]
    device = grads[0].device if device is None else device
    if len(norms) == 1:
        return norms[0].to(device)
    return torch.linalg.vector_norm(torch.stack([n.to(device)
                                                 for n in norms]))


def param_grads(model: nn.Module, loss: torch.Tensor):
    """(names, parameters, gradients): parameters the loss does not reach
    get zero gradients, as under ``jax.grad``."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return [n for n, _ in named], params, grads


def grads_and_norm(model: nn.Module, loss: torch.Tensor):
    """(names, parameters, gradients, global norm)."""
    names, params, grads = param_grads(model, loss)
    return names, params, grads, global_norm(grads)


def clipped(grads, ok: torch.Tensor, scale: torch.Tensor) -> list:
    """Each gradient times ``scale``, or 0 when not ``ok``
    (``torch.where``: 0 · NaN is NaN); ``ok``, ``scale`` and the
    gradients on one device."""
    out = [torch.where(ok, g, 0.0) for g in grads]
    torch._foreach_mul_(out, scale)
    return out


def f32_product(lr: float, lr_scale: float) -> float:
    """``lr · lr_scale`` rounded as JAX computes it: both in float32."""
    return float(np.float32(lr) * np.float32(lr_scale))


def init_momentum(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Zero momentum for every parameter, keyed by its name."""
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in model.named_parameters()}


LossFn = Callable[..., Tuple[torch.Tensor, Dict]]


def detached(aux: Dict, **more) -> Dict:
    """The step's aux dict, every tensor cut from the graph."""
    return {k: v.detach() if torch.is_tensor(v) else v
            for k, v in dict(aux, **more).items()}


class TrainStep:
    """A family's train step: ``step(model, state, *batch, lr_scale=1.0)
    → (loss, aux)``, the model's parameters and ``state`` (from
    :meth:`init`) updated in place; ``aux`` adds the gradient norm and
    ``ok`` (False on a skipped batch). The data-parallel step
    (``parallel/data.py``) runs the same ``loss_fn`` parts, :meth:`guard`,
    :meth:`apply` and :meth:`finish` on the replicas' summed gradients."""

    def __init__(self, loss_fn: LossFn, lr: float, clip_norm: float):
        self.loss_fn, self.lr, self.clip_norm = loss_fn, lr, clip_norm

    def init(self, model: nn.Module) -> Dict:
        raise NotImplementedError

    def guard(self, loss: torch.Tensor, gnorm: torch.Tensor):
        """(ok, scale): ``ok`` when the loss and the gradient norm are
        finite; the clip ``min(1, clip / (‖g‖ + 1e-9))``, 0 when not ok."""
        ok = torch.isfinite(gnorm) & torch.isfinite(loss)
        scale = torch.where(ok, torch.clamp(self.clip_norm / (gnorm + 1e-9),
                                            max=1.0),
                            torch.zeros_like(gnorm))
        return ok, scale

    def apply(self, names, params, grads, state: Dict, ok: torch.Tensor,
              scale: torch.Tensor, lr_scale: float) -> None:
        """The update of ``params`` (all on the device of ``ok`` and
        ``scale``) and of their entries of ``state``."""
        raise NotImplementedError

    def finish(self, state: Dict, ok: torch.Tensor) -> None:
        """What the update keeps once per step, whatever the devices."""

    def __call__(self, model, state, *batch, lr_scale: float = 1.0):
        with timed("forward_loss"):
            loss, aux = self.loss_fn(model, *batch)
        with timed("backward"):
            names, params, grads, gnorm = grads_and_norm(model, loss)
        with timed("optimizer"), torch.no_grad():
            ok, scale = self.guard(loss, gnorm)
            self.apply(names, params, grads, state, ok, scale, lr_scale)
            self.finish(state, ok)
        return loss.detach(), detached(aux, grad_norm=gnorm, ok=ok)


class SGDStep(TrainStep):
    """The JAX step's SGD with momentum 0.9."""

    init = staticmethod(init_momentum)

    def apply(self, names, params, grads, state, ok, scale, lr_scale):
        step = clipped(grads, ok, scale)
        moms = [state[n] for n in names]
        torch._foreach_mul_(moms, 0.9)
        torch._foreach_add_(moms, step)
        torch._foreach_sub_(params, torch._foreach_mul(
            moms, f32_product(self.lr, lr_scale)))


def make_train_step(loss_fn: LossFn = detection_loss, lr: float = 1e-3,
                    clip_norm: float = 10.0) -> SGDStep:
    """``make_train_step`` :207: ``step(model, momentum, images, gt_boxes,
    gt_cls, gt_mask, *extra, lr_scale=1.0) → (loss, aux)``, the model's
    parameters and ``momentum`` updated in place; ``aux`` adds the
    gradient norm and ``ok`` (False on a skipped batch)."""
    return SGDStep(loss_fn, lr, clip_norm)


def make_ema_update(decay: float = 0.9990, tau: float = 2000.0):
    """``make_ema_update`` :245: ``update(ema_model, model, step)``, the
    decay ``decay · (1 − e^(−step/τ))`` computed in float32 (on the host:
    no device round trip)."""

    def update(ema: nn.Module, model: nn.Module, step: int) -> None:
        f32 = np.float32
        d = float(f32(decay) * (f32(1.0) - np.exp(-f32(step) / f32(tau))))
        with torch.no_grad():
            for e, p in zip(ema.parameters(), model.parameters()):
                e.copy_(d * e + (1.0 - d) * p)

    return update


_CONSTANTS: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def device_constant(name: str, value, device: torch.device) -> torch.Tensor:
    """A float32 constant uploaded once per device (a per-step upload from
    pageable host memory would synchronise the step)."""
    key = (name, torch.device(device))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.as_tensor(np.asarray(value, np.float32),
                                          device=device)
    return _CONSTANTS[key]
