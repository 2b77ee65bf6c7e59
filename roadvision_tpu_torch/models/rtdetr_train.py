"""RT-DETR set-prediction training — the port of
``roadvision_tpu/models/rtdetr_train.py``.

The objective is the JAX package's: per prediction set (the encoder's
top-nq proposals and each of the six decoder layers) a bipartite match
of gts to queries by the cost 2·focal-class + 5·L1(cxcywh) + 2·(1 − GIoU),
then varifocal classification (IoU-aware targets, α 0.75, γ 2), L1 and
GIoU on the matched pairs with gains 1 / 5 / 2, each over the batch's gt
count. No denoising query groups, as in JAX.

The matching is the parallel ε-auction of :func:`hungarian_match`
(ε = 1e-3, at most 1024 rounds), within M·ε of the optimum. JAX runs one
device ``while_loop`` per (set, image). Here every problem of a step —
B images × (1 + decoder layers) sets — goes to one batched auction under
``no_grad``. On the card that is one launch of K5 ``assoc_auction`` in
its matcher mode (``csrc/assoc.cu``: a thread block a problem, every
round on the device, no host read). On the CPU it is the plain version,
:func:`hungarian_match_plain`, with one host read of "any gt still
unassigned" per :data:`AUCTION_BLOCK` rounds (:data:`host_syncs` counts
them). That is exact: a finished problem has no bidder, so further
rounds change neither its prices nor its assignment, and the round cap
is the same for all.

The forward is ``RTDETR.forward_train``, whose deformable sampling goes
through ``ops/deform.py::deform_sample`` with f32 values: on the card one
K7 launch a decoder layer forward and one K8 launch a layer backward
(the data-parallel replicas' objective likewise, each replica its own).

:func:`make_train_step_rtdetr` is the JAX step's AdamW (β 0.9 / 0.999,
ε 1e-8, decoupled weight decay on parameters with ndim ≥ 2 only) with the
global-norm clip 0.1 and the non-finite guard, which leaves the moments
and the step count untouched on a skipped batch; multi-tensor
``torch._foreach_*`` operations over all parameters.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import _build
from .yolo.train import (Objective, TrainStep, clipped, f32_product,
                         sigmoid_bce, timed)

EPS = 1e-9
AUCTION_EPS = 1e-3
AUCTION_MAX_ITERS = 1024
AUCTION_BLOCK = 8          # auction rounds between two reads of "done"

# matcher cost gains (ultralytics HungarianMatcher cost_gain for RTDETR)
COST_CLASS, COST_BBOX, COST_GIOU = 2.0, 5.0, 2.0
# loss gains (DETRLoss loss_gain)
GAIN_CLASS, GAIN_BBOX, GAIN_GIOU = 1.0, 5.0, 2.0
VFL_ALPHA, VFL_GAMMA = 0.75, 2.0

# reads of the auction's "done" flag since the last reset
host_syncs = 0


def reset_host_syncs() -> None:
    global host_syncs
    host_syncs = 0


def _read_flag(t: torch.Tensor) -> bool:
    global host_syncs
    host_syncs += 1
    return bool(t)


def _overlap(box1: torch.Tensor, box2: torch.Tensor):
    """(inter, union) of broadcastable (..., 4) xyxy boxes."""
    x1 = torch.maximum(box1[..., 0], box2[..., 0])
    y1 = torch.maximum(box1[..., 1], box2[..., 1])
    x2 = torch.minimum(box1[..., 2], box2[..., 2])
    y2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    a1 = (box1[..., 2] - box1[..., 0]).clamp(min=0) \
        * (box1[..., 3] - box1[..., 1]).clamp(min=0)
    a2 = (box2[..., 2] - box2[..., 0]).clamp(min=0) \
        * (box2[..., 3] - box2[..., 1]).clamp(min=0)
    return inter, a1 + a2 - inter


def iou_xyxy(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Plain IoU between broadcastable (..., 4) xyxy boxes."""
    inter, union = _overlap(box1, box2)
    return inter / (union + EPS)


def giou_xyxy(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Generalised IoU between broadcastable (..., 4) xyxy boxes."""
    inter, union = _overlap(box1, box2)
    iou = inter / (union + EPS)
    cw = torch.maximum(box1[..., 2], box2[..., 2]) \
        - torch.minimum(box1[..., 0], box2[..., 0])
    ch = torch.maximum(box1[..., 3], box2[..., 3]) \
        - torch.minimum(box1[..., 1], box2[..., 1])
    carea = cw * ch + EPS
    return iou - (carea - union) / carea


def hungarian_match_plain(cost: torch.Tensor, gt_mask: torch.Tensor,
                          eps: float = AUCTION_EPS,
                          max_iters: int = AUCTION_MAX_ITERS) -> torch.Tensor:
    """``hungarian_match`` :82 over a batch of problems: cost (P, M, NQ),
    gt_mask (P, M) bool → (P, M) int64 query per gt, −1 for masked rows
    (and rows left unassigned after ``max_iters`` rounds). Each valid gt
    bids ``best − second best + ε`` for its best-value query, each query
    goes to its highest bidder (first row on ties)."""
    p, m, nq = cost.shape
    dev = cost.device
    neg = -1e9
    w = torch.where(gt_mask[..., None], -cost,
                    torch.full_like(cost, neg))
    row_ids = torch.arange(m, device=dev)[None].expand(p, m)
    col_ids = torch.arange(nq, device=dev)
    prices = torch.zeros((p, nq), dtype=torch.float32, device=dev)
    assigned = torch.full((p, m), -1, dtype=torch.int64, device=dev)

    def round_(prices, assigned):
        values = w - prices[:, None, :]
        v1 = values.amax(dim=2)
        best_c = values.argmax(dim=2)
        v2 = values.scatter(2, best_c[..., None], neg).amax(dim=2)
        bidding = (assigned < 0) & gt_mask
        incr = v1 - v2 + eps
        bid_mat = torch.where(
            bidding[..., None] & (best_c[..., None] == col_ids),
            incr[..., None], float("-inf"))               # (P, M, NQ)
        top_bid = bid_mat.amax(dim=1)
        winner = bid_mat.argmax(dim=1)                     # (P, NQ)
        has_bid = top_bid > float("-inf")
        prices = torch.where(has_bid, prices + top_bid, prices)
        own_c = assigned.clamp(0, nq - 1)
        evicted = (assigned >= 0) & has_bid.gather(1, own_c) \
            & (winner.gather(1, own_c) != row_ids)
        assigned = torch.where(evicted, -1, assigned)
        won = bidding & has_bid.gather(1, best_c) \
            & (winner.gather(1, best_c) == row_ids)
        assigned = torch.where(won, best_c, assigned)
        return prices, assigned

    it = 0
    while it < max_iters and _read_flag((gt_mask & (assigned < 0)).any()):
        for _ in range(min(AUCTION_BLOCK, max_iters - it)):
            prices, assigned = round_(prices, assigned)
        it += AUCTION_BLOCK
    return torch.where(gt_mask, assigned, torch.full_like(assigned, -1))


def _match_cuda(cost, gt_mask, eps: float, max_iters: int) -> torch.Tensor:
    from ..track.sort import AUCTION_MATCHER, auction_workspace
    if cost.dim() != 3 or cost.dtype != torch.float32 \
            or gt_mask.shape != cost.shape[:2] \
            or gt_mask.device != cost.device:
        raise ValueError(f"hungarian_match: expected cost (P, M, NQ) float32 "
                         f"and gt_mask (P, M) on its device, got "
                         f"{tuple(cost.shape)} {cost.dtype}, "
                         f"{tuple(gt_mask.shape)} on {gt_mask.device}")
    p, m, nq = cost.shape
    out = torch.empty((p, m), dtype=torch.int64, device=cost.device)
    if out.numel() == 0:
        return out
    if nq == 0 or p > 2 ** 31 - 1:
        raise ValueError(f"hungarian_match: {p} problems of {m} x {nq}")
    c = cost.contiguous()
    mask = gt_mask.to(torch.bool).contiguous().view(torch.uint8)
    lib = _build.load("assoc")
    ws = auction_workspace(lib, AUCTION_MATCHER, nq, m, p, cost.device)
    with torch.cuda.device(cost.device):
        code = lib.rvt_auction_match(
            c.data_ptr(), mask.data_ptr(), out.data_ptr(),
            0 if ws is None else ws.data_ptr(), p, m, nq,
            ctypes.c_float(float(eps)), int(max_iters),
            _build.stream_ptr(cost))
    _build.launch_counts["assoc_auction"] += 1
    _build.check(code, "assoc_auction")
    return out


def hungarian_match(cost: torch.Tensor, gt_mask: torch.Tensor,
                    eps: float = AUCTION_EPS,
                    max_iters: int = AUCTION_MAX_ITERS) -> torch.Tensor:
    """K5 in its matcher mode: :func:`hungarian_match_plain`'s result,
    (P, M) int64 query per gt, −1 for masked rows, for cost (P, M, NQ)
    and gt_mask (P, M). A CPU tensor runs the plain version; a CUDA
    tensor (float32) launches the kernel, every problem in one launch, on
    the current stream, with no host read."""
    if cost.device.type == "cpu":
        return hungarian_match_plain(cost, gt_mask, eps, max_iters)
    if cost.device.type != "cuda":
        raise ValueError(f"hungarian_match: unsupported device "
                         f"{cost.device}")
    return _match_cuda(cost, gt_mask, eps, max_iters)


def _cxcywh(xyxy: torch.Tensor) -> torch.Tensor:
    return torch.cat([(xyxy[..., :2] + xyxy[..., 2:]) * 0.5,
                      xyxy[..., 2:] - xyxy[..., :2]], dim=-1)


def _xyxy(sig_cxcywh: torch.Tensor) -> torch.Tensor:
    c, wh = sig_cxcywh[..., :2], sig_cxcywh[..., 2:]
    return torch.cat([c - wh / 2, c + wh / 2], dim=-1)


def match_cost(pred_xyxy, pred_logits, gt_xyxy, gt_cls) -> torch.Tensor:
    """The matcher's cost (B, M, NQ) of one prediction set (the ``one``
    closure of ``_set_loss`` :150-160, batched)."""
    prob = torch.sigmoid(pred_logits)                      # (B, NQ, nc)
    idx = gt_cls.long()[:, :, None].expand(-1, -1, prob.shape[1])
    p_cls = torch.gather(prob.transpose(1, 2), 1, idx)     # (B, M, NQ)
    neg_cost = (1 - VFL_ALPHA) * (p_cls ** VFL_GAMMA) \
        * (-torch.log(1 - p_cls + EPS))
    pos_cost = VFL_ALPHA * ((1 - p_cls) ** VFL_GAMMA) \
        * (-torch.log(p_cls + EPS))
    l1 = (_cxcywh(gt_xyxy)[:, :, None] - _cxcywh(pred_xyxy)[:, None]) \
        .abs().sum(-1)
    gi = giou_xyxy(gt_xyxy[:, :, None], pred_xyxy[:, None])
    return COST_CLASS * (pos_cost - neg_cost) + COST_BBOX * l1 \
        + COST_GIOU * (1.0 - gi)


def _set_loss(pred_xyxy, pred_logits, gt_xyxy, gt_cls, gt_mask,
              q_idx, nc: int) -> Tuple[torch.Tensor, ...]:
    """``_set_loss`` :136 with the match given: (cls, l1, giou) sums of
    one prediction set over the batch. pred_xyxy (B, NQ, 4) normalised;
    pred_logits (B, NQ, nc); gt (B, M, ·); q_idx (B, M)."""
    b, num_q, _ = pred_xyxy.shape
    gm_a = gt_mask & (q_idx >= 0)
    qc = q_idx.clamp(0, num_q - 1)
    mb = torch.gather(pred_xyxy, 1, qc[..., None].expand(-1, -1, 4))
    zero = torch.zeros(gm_a.shape, dtype=torch.float32,
                       device=pred_xyxy.device)
    l1_loss = torch.where(gm_a, (_cxcywh(mb) - _cxcywh(gt_xyxy)).abs()
                          .sum(-1), zero).sum()
    giou_loss = torch.where(gm_a, 1.0 - giou_xyxy(mb, gt_xyxy), zero).sum()

    iou_w = torch.where(gm_a, iou_xyxy(mb.detach(), gt_xyxy),
                        zero).clamp(0.0, 1.0)
    scat = torch.where(gm_a, q_idx, torch.full_like(q_idx, num_q))
    t_iou = torch.zeros((b, num_q + 1), dtype=torch.float32,
                        device=pred_xyxy.device).scatter(1, scat, iou_w)
    t_cls = torch.full((b, num_q + 1), nc, dtype=torch.int64,
                       device=pred_xyxy.device).scatter(1, scat,
                                                        gt_cls.long())
    one_hot = F.one_hot(t_cls[:, :num_q], nc + 1)[..., :nc].float()
    target = one_hot * t_iou[:, :num_q, None]
    pw = torch.sigmoid(pred_logits).detach()
    weight = VFL_ALPHA * (pw ** VFL_GAMMA) * (1.0 - one_hot) + target
    cls_loss = (sigmoid_bce(pred_logits, target) * weight).sum()
    return cls_loss, l1_loss, giou_loss


def rtdetr_parts(model: nn.Module, images: torch.Tensor,
                 gt_boxes: torch.Tensor, gt_cls: torch.Tensor,
                 gt_mask: torch.Tensor):
    """The :class:`~.yolo.train.Objective` parts of ``rtdetr_loss`` :197:
    images (B, S, S, 3) float [0, 1]; gt_boxes (B, M, 4) pixel xyxy;
    gt_cls (B, M); gt_mask (B, M) bool. The class, L1 and GIoU sums over
    every prediction set, and the gt count they are divided by. All
    sets' matches come from one batched auction."""
    s = images.shape[1]
    gt_n = gt_boxes / float(s)
    aux = model.forward_train(images)
    nc = aux["enc_scores"].shape[-1]
    sets = [(aux["enc_boxes"], aux["enc_scores"])] \
        + list(zip(aux["boxes"], aux["scores"]))
    sets = [(_xyxy(boxes), logits) for boxes, logits in sets]

    with timed("assign"), torch.no_grad():
        cost = torch.cat([match_cost(bx.detach(), lg.detach(), gt_n, gt_cls)
                          for bx, lg in sets])
        q_all = hungarian_match(cost, gt_mask.repeat(len(sets), 1))
    q_sets = q_all.split(gt_mask.shape[0])

    cls_t = l1_t = giou_t = 0.0
    for (bx, lg), q_idx in zip(sets, q_sets):
        cl, l1l, gil = _set_loss(bx, lg, gt_n, gt_cls, gt_mask, q_idx, nc)
        cls_t = cls_t + cl
        l1_t = l1_t + l1l
        giou_t = giou_t + gil
    n_gt = gt_mask.sum()
    return {"cls": cls_t, "l1": l1_t, "giou": giou_t}, {"gts": n_gt}, \
        {"num_fg": n_gt}


def rtdetr_total(sums: Dict, counts: Dict, nc: int):
    """Each sum times its gain over the batch's gt count (at least 1)."""
    num_gt = counts["gts"].clamp(min=1).float()
    cls_t = GAIN_CLASS * sums["cls"] / num_gt
    l1_t = GAIN_BBOX * sums["l1"] / num_gt
    giou_t = GAIN_GIOU * sums["giou"] / num_gt
    return cls_t + l1_t + giou_t, {"cls": cls_t, "l1": l1_t, "giou": giou_t}


rtdetr_loss = Objective(rtdetr_parts, rtdetr_total)


def init_opt_rtdetr(model: nn.Module) -> Dict:
    """``init_opt_rtdetr`` :232: AdamW moments keyed by parameter name and
    the bias-correction step count ``t`` (int32)."""
    dev = next(model.parameters()).device
    zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                     for n, p in model.named_parameters()}
    return {"m": zeros(), "v": zeros(),
            "t": torch.zeros((), dtype=torch.int32, device=dev)}


class AdamWStep(TrainStep):
    """AdamW (decoupled weight decay on parameters with ndim ≥ 2 only); a
    skipped batch keeps the moments and the step count."""

    init = staticmethod(init_opt_rtdetr)

    def __init__(self, lr: float, clip_norm: float, weight_decay: float,
                 b1: float, b2: float):
        super().__init__(rtdetr_loss, lr, clip_norm)
        self.weight_decay, self.b1, self.b2 = weight_decay, b1, b2

    def apply(self, names, params, grads, opt, ok, scale, lr_scale):
        b1, b2 = self.b1, self.b2
        sg = clipped(grads, ok, scale)
        one = torch.ones((), device=ok.device)
        # a skipped batch keeps the moments: β → 1 and the (zeroed)
        # gradient's share 1 − β → 0
        beta1 = torch.where(ok, b1 * one, one)
        beta2 = torch.where(ok, b2 * one, one)
        share1 = torch.where(ok, (1.0 - b1) * one, 0.0 * one)
        share2 = torch.where(ok, (1.0 - b2) * one, 0.0 * one)
        t = opt["t"].to(ok.device) + ok.to(torch.int32)
        tc = t.clamp(min=1).float()
        bc1 = 1.0 - b1 ** tc
        bc2 = 1.0 - b2 ** tc
        ms = [opt["m"][n] for n in names]
        vs = [opt["v"][n] for n in names]
        torch._foreach_mul_(ms, beta1)
        torch._foreach_add_(ms, torch._foreach_mul(sg, share1))
        torch._foreach_mul_(vs, beta2)
        torch._foreach_add_(vs, torch._foreach_mul(
            torch._foreach_mul(sg, sg), share2))
        den = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, 1e-8)
        upd = torch._foreach_div(ms, bc1)
        torch._foreach_div_(upd, den)
        mats = [i for i, p in enumerate(params) if p.dim() >= 2]
        torch._foreach_add_([upd[i] for i in mats], torch._foreach_mul(
            [params[i] for i in mats], self.weight_decay))
        step_lr = torch.where(ok, f32_product(self.lr, lr_scale) * one,
                              0.0 * one)
        torch._foreach_sub_(params, torch._foreach_mul(upd, step_lr))

    def finish(self, opt, ok):
        opt["t"] = opt["t"] + ok.to(opt["t"].device, torch.int32)


def make_train_step_rtdetr(lr: float = 1e-4, clip_norm: float = 0.1,
                           weight_decay: float = 1e-4, b1: float = 0.9,
                           b2: float = 0.999) -> AdamWStep:
    """``make_train_step_rtdetr`` :242: ``step(model, opt, images,
    gt_boxes, gt_cls, gt_mask, lr_scale=1.0) → (loss, aux)``, the model
    and ``opt`` (:func:`init_opt_rtdetr`) updated in place."""
    return AdamWStep(lr, clip_norm, weight_decay, b1, b2)


__all__: List[str] = ["iou_xyxy", "giou_xyxy", "hungarian_match",
                      "hungarian_match_plain", "rtdetr_loss", "init_opt_rtdetr", "AdamWStep",
                      "make_train_step_rtdetr"]
