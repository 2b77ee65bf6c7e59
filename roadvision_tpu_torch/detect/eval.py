"""mAP for the detector families — the port of
``roadvision_tpu/detect/eval.py`` (host numpy, a copy).

Box mAP (:func:`evaluate_detector`), mask mAP (:func:`evaluate_segmenter`),
keypoint OKS mAP (:func:`evaluate_pose`) and rotated-box ProbIoU mAP
(:func:`evaluate_obb`), each driving a port detector through its
``infer_batch`` one frame at a time: the JAX module's 101-point
interpolated COCO-style AP with greedy matching by confidence, plus a
box-match recall / precision report.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    ax1, ay1, ax2, ay2 = a[:, 0:1], a[:, 1:2], a[:, 2:3], a[:, 3:4]
    bx1, by1, bx2, by2 = b[None, :, 0], b[None, :, 1], b[None, :, 2], b[None, :, 3]
    iw = np.maximum(0, np.minimum(ax2, bx2) - np.maximum(ax1, bx1))
    ih = np.maximum(0, np.minimum(ay2, by2) - np.maximum(ay1, by1))
    inter = iw * ih
    area_a = np.maximum(0, ax2 - ax1) * np.maximum(0, ay2 - ay1)
    area_b = np.maximum(0, bx2 - bx1) * np.maximum(0, by2 - by1)
    union = area_a + area_b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def mask_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, H, W) × (M, H, W) boolean masks → (N, M) IoU. One matmul on
    the flattened masks for the intersections; unions from the areas."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    af = np.asarray(a, bool).reshape(len(a), -1).astype(np.float32)
    bf = np.asarray(b, bool).reshape(len(b), -1).astype(np.float32)
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def _ap_from_records(records: List[Tuple[float, bool]],
                     total_gt: int) -> float:
    """COCO-style 101-point interpolated AP from (conf, is_tp) records."""
    if total_gt == 0 or not records:
        return 0.0
    records.sort(key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in records])
    fp = np.cumsum([not r[1] for r in records])
    recall = tp / total_gt
    precision = tp / np.maximum(tp + fp, 1e-9)
    # 101-point interpolated AP
    ap = 0.0
    for r in np.linspace(0, 1, 101):
        mask = recall >= r
        ap += float(precision[mask].max()) if mask.any() else 0.0
    return ap / 101.0


def _greedy_match_records(iou: np.ndarray, pc: np.ndarray,
                          iou_thres: float,
                          records: List[Tuple[float, bool]]) -> None:
    """Confidence-descending greedy match of one image's (N, M) IoU
    matrix; appends (conf, is_tp) per prediction."""
    n, m = iou.shape
    taken = np.zeros(m, bool)
    for i in np.argsort(-pc, kind="stable"):
        if m == 0:
            records.append((float(pc[i]), False))
            continue
        j = int(np.argmax(np.where(taken, -1.0, iou[i])))
        if iou[i, j] >= iou_thres and not taken[j]:
            taken[j] = True
            records.append((float(pc[i]), True))
        else:
            records.append((float(pc[i]), False))


def average_precision(pred_boxes: Sequence[np.ndarray],
                      pred_conf: Sequence[np.ndarray],
                      gt_boxes: Sequence[np.ndarray],
                      iou_thres: float = 0.5) -> float:
    """Single-class AP over a set of images (101-point interpolation).

    pred_boxes[i]: (Ni, 4); pred_conf[i]: (Ni,); gt_boxes[i]: (Mi, 4).
    """
    records: List[Tuple[float, bool]] = []
    total_gt = 0
    for pb, pc, gb in zip(pred_boxes, pred_conf, gt_boxes):
        pb, pc, gb = np.asarray(pb), np.asarray(pc), np.asarray(gb)
        total_gt += len(gb)
        _greedy_match_records(_iou_matrix(pb, gb), pc, iou_thres, records)
    return _ap_from_records(records, total_gt)


def average_precision_masks(pred_masks: Sequence[np.ndarray],
                            pred_conf: Sequence[np.ndarray],
                            gt_masks: Sequence[np.ndarray],
                            iou_thres: float = 0.5) -> float:
    """Single-class MASK AP (segment task): same matching/interpolation
    as :func:`average_precision` with pixel-IoU instead of box-IoU.
    pred_masks[i]: (Ni, H, W) bool; gt_masks[i]: (Mi, H, W) bool."""
    records: List[Tuple[float, bool]] = []
    total_gt = 0
    for pm, pc, gm in zip(pred_masks, pred_conf, gt_masks):
        pc = np.asarray(pc)
        total_gt += len(gm)
        _greedy_match_records(mask_iou_matrix(pm, gm), pc, iou_thres,
                              records)
    return _ap_from_records(records, total_gt)


def mean_ap(per_class_preds: Dict[int, Tuple[list, list]],
            per_class_gts: Dict[int, list],
            iou_thresholds: Sequence[float] = (0.5,)) -> Dict[str, float]:
    """mAP across classes and IoU thresholds.

    per_class_preds[c] = (list of per-image boxes, list of per-image conf);
    per_class_gts[c] = list of per-image gt boxes.
    """
    out = {}
    for thr in iou_thresholds:
        aps = []
        for c, (boxes, confs) in per_class_preds.items():
            gts = per_class_gts.get(c, [np.zeros((0, 4))] * len(boxes))
            aps.append(average_precision(boxes, confs, gts, thr))
        out[f"mAP@{thr:g}"] = float(np.mean(aps)) if aps else 0.0
    return out


def evaluate_detector(det, images: np.ndarray, gt_boxes: np.ndarray,
                      gt_cls: np.ndarray, gt_mask: np.ndarray,
                      iou_thresholds: Sequence[float] = (0.5,)
                      ) -> Dict[str, float]:
    """Run a detector over (N, S, S, 3) RGB uint8 images and score mAP.

    Shared by tools/eval_map.py and the trainer's --eval-every hook:
    collects per-frame records first, then builds per-class lists
    aligned over ALL frames (a class may first appear mid-dataset).
    """
    from collections import defaultdict

    records = []
    classes = set()
    for i in range(images.shape[0]):
        bgr = images[i][..., ::-1]
        batch = det.infer_batch(bgr[None])
        boxes = batch.boxes[0][batch.valid[0]]
        conf = batch.conf[0][batch.valid[0]]
        cls = batch.cls_id[0][batch.valid[0]]
        fg_boxes = gt_boxes[i][gt_mask[i]]
        fg_cls = gt_cls[i][gt_mask[i]]
        records.append((boxes, conf, cls, fg_boxes, fg_cls))
        classes.update(int(c) for c in np.unique(fg_cls))
        classes.update(int(c) for c in np.unique(cls))

    preds = {c: ([], []) for c in classes}
    gts = defaultdict(list)
    for boxes, conf, cls, fg_boxes, fg_cls in records:
        for c in classes:
            sel = cls == c
            preds[c][0].append(boxes[sel])
            preds[c][1].append(conf[sel])
            gts[c].append(fg_boxes[fg_cls == c])
    return mean_ap(preds, dict(gts), iou_thresholds)


def evaluate_segmenter(det, images: np.ndarray,
                       gt_masks: Sequence[Sequence[np.ndarray]],
                       gt_cls: Sequence[np.ndarray],
                       iou_thresholds: Sequence[float] = (0.5,)
                       ) -> Dict[str, float]:
    """Mask mAP for the segment task (beyond-reference; the detect-task
    analogue is :func:`evaluate_detector`).

    images (N, H, W, 3) RGB uint8; gt_masks[i] = list of (H, W) bool
    instance masks; gt_cls[i] = (Mi,) class ids. The detector must run
    ``task="segment"``; predicted prototype-resolution masks are pasted
    to frame pixels with the detector's letterbox metadata before
    pixel-IoU matching. Returns {"mask_mAP@t": ...} per threshold.
    """
    from collections import defaultdict

    from ..ops.masks import paste_masks

    records = []
    classes = set()
    h, w = images.shape[1:3]
    for i in range(images.shape[0]):
        bgr = images[i][..., ::-1]
        batch = det.infer_batch(bgr[None])
        ratio, pad = det.last_letterbox_meta()
        full = paste_masks(batch.masks[0], batch.valid[0], ratio, pad,
                           (h, w))
        v = batch.valid[0]
        records.append((full[v], batch.conf[0][v], batch.cls_id[0][v],
                        np.asarray(gt_masks[i], bool).reshape(-1, h, w),
                        np.asarray(gt_cls[i])))
        classes.update(int(c) for c in np.unique(batch.cls_id[0][v]))
        classes.update(int(c) for c in np.unique(gt_cls[i]))

    out = {}
    for thr in iou_thresholds:
        aps = []
        for c in sorted(classes):
            pm, pc_, gm = [], [], []
            for masks, conf, cls, gmasks, gcls in records:
                sel = cls == c
                pm.append(masks[sel])
                pc_.append(conf[sel])
                gm.append(gmasks[np.asarray(gcls) == c])
            aps.append(average_precision_masks(pm, pc_, gm, thr))
        out[f"mask_mAP@{thr:g}"] = float(np.mean(aps)) if aps else 0.0
    return out


def oks_matrix(pred_kpts: np.ndarray, gt_kpts: np.ndarray,
               gt_areas: np.ndarray) -> np.ndarray:
    """(N, 17, 3) predicted × (M, 17, 3) gt keypoints → (N, M) OKS
    (cocoeval convention): per labelled gt joint
    exp(−d² / (2·area·k²)) with k = 2σ, averaged over labelled joints.
    gt_areas (M,) are gt box areas in the same pixel units."""
    from ..models.yolo.train_pose import OKS_SIGMAS

    if len(pred_kpts) == 0 or len(gt_kpts) == 0:
        return np.zeros((len(pred_kpts), len(gt_kpts)), np.float32)
    p = np.asarray(pred_kpts, np.float32)[:, None]       # (N,1,17,3)
    g = np.asarray(gt_kpts, np.float32)[None]            # (1,M,17,3)
    d2 = (p[..., 0] - g[..., 0]) ** 2 + (p[..., 1] - g[..., 1]) ** 2
    k2 = (2.0 * OKS_SIGMAS[None, None]) ** 2             # (1,1,17)
    area = np.maximum(np.asarray(gt_areas, np.float32), 1.0)
    e = d2 / (2.0 * area[None, :, None] * k2)
    lab = (g[..., 2] > 0).astype(np.float32)             # (1,M,17)
    n_lab = np.maximum(lab.sum(-1), 1e-9)
    return (np.exp(-e) * lab).sum(-1) / n_lab


def average_precision_oks(pred_kpts: Sequence[np.ndarray],
                          pred_conf: Sequence[np.ndarray],
                          gt_kpts: Sequence[np.ndarray],
                          gt_areas: Sequence[np.ndarray],
                          oks_thres: float = 0.5) -> float:
    """Single-class KEYPOINT AP (pose task): the matching/interpolation
    of :func:`average_precision` with OKS as the similarity."""
    records: List[Tuple[float, bool]] = []
    total_gt = 0
    for pk, pc, gk, ga in zip(pred_kpts, pred_conf, gt_kpts, gt_areas):
        pc = np.asarray(pc)
        total_gt += len(gk)
        _greedy_match_records(oks_matrix(pk, gk, ga), pc, oks_thres,
                              records)
    return _ap_from_records(records, total_gt)


def evaluate_pose(det, images: np.ndarray, gt_boxes: np.ndarray,
                  gt_kpts: np.ndarray, gt_mask: np.ndarray,
                  oks_thresholds: Sequence[float] = (0.5,)
                  ) -> Dict[str, float]:
    """Keypoint mAP for the pose task (beyond-reference; the detect-task
    analogue is :func:`evaluate_detector`). Single-class by convention
    (-pose checkpoints are person-only).

    images (N, H, W, 3) RGB uint8; gt_boxes (N, M, 4) xyxy px (for OKS
    areas); gt_kpts (N, M, 17, 3) with v>0 labelled; gt_mask (N, M)
    slot validity. The detector must run ``task="pose"``. Returns
    {"oks_mAP@t": ...} per threshold.
    """
    pk, pc, gk, ga = [], [], [], []
    for i in range(images.shape[0]):
        bgr = images[i][..., ::-1]
        batch = det.infer_batch(bgr[None])
        v = batch.valid[0]
        pk.append(batch.keypoints[0][v])
        pc.append(batch.conf[0][v])
        fg = gt_mask[i]
        gk.append(gt_kpts[i][fg])
        b = gt_boxes[i][fg]
        ga.append((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))
    return {f"oks_mAP@{thr:g}": average_precision_oks(pk, pc, gk, ga, thr)
            for thr in oks_thresholds}


def rbox_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 5) × (M, 5) rotated boxes (cx, cy, w, h, θ) → (N, M) ProbIoU.

    Host-side numpy twin of ops.obb.probiou_pairs (same closed-form
    Gaussian Bhattacharyya math; eval runs off-device, like
    :func:`_iou_matrix` for axis-aligned boxes)."""
    a = np.asarray(a, np.float32).reshape(-1, 5)
    b = np.asarray(b, np.float32).reshape(-1, 5)
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    eps = 1e-7

    def cov(rb):
        va = rb[:, 2] ** 2 / 12.0
        vb = rb[:, 3] ** 2 / 12.0
        c, s = np.cos(rb[:, 4]), np.sin(rb[:, 4])
        return (va * c ** 2 + vb * s ** 2, va * s ** 2 + vb * c ** 2,
                (va - vb) * c * s)

    a1, b1, c1 = (v[:, None] for v in cov(a))
    a2, b2, c2 = (v[None, :] for v in cov(b))
    x1, y1 = a[:, 0][:, None], a[:, 1][:, None]
    x2, y2 = b[:, 0][None, :], b[:, 1][None, :]
    den = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) \
        / (den + eps) * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / (den + eps) * 0.5
    d1 = np.maximum(a1 * b1 - c1 ** 2, 0.0)
    d2 = np.maximum(a2 * b2 - c2 ** 2, 0.0)
    t3 = np.log(den / (4.0 * np.sqrt(d1 * d2) + eps) + eps) * 0.5
    bd = np.clip(t1 + t2 + t3, eps, 100.0)
    return 1.0 - np.sqrt(1.0 - np.exp(-bd) + eps)


def average_precision_rboxes(pred_rboxes: Sequence[np.ndarray],
                             pred_conf: Sequence[np.ndarray],
                             gt_rboxes: Sequence[np.ndarray],
                             iou_thres: float = 0.5) -> float:
    """Single-class ROTATED-box AP (obb task): the matching and
    interpolation of :func:`average_precision` with ProbIoU as the
    similarity (the DOTA-style rotated mAP analogue)."""
    records: List[Tuple[float, bool]] = []
    total_gt = 0
    for pb, pc, gb in zip(pred_rboxes, pred_conf, gt_rboxes):
        pc = np.asarray(pc)
        total_gt += len(gb)
        _greedy_match_records(rbox_iou_matrix(pb, gb), pc, iou_thres,
                              records)
    return _ap_from_records(records, total_gt)


def evaluate_obb(det, images: np.ndarray, gt_rboxes: np.ndarray,
                 gt_cls: np.ndarray, gt_mask: np.ndarray,
                 iou_thresholds: Sequence[float] = (0.5,)
                 ) -> Dict[str, float]:
    """Rotated-box mAP for the obb task (beyond-reference; the
    detect-task analogue is :func:`evaluate_detector`).

    images (N, H, W, 3) RGB uint8; gt_rboxes (N, M, 5) cx, cy, w, h px
    + θ rad; gt_cls (N, M) i32; gt_mask (N, M) slot validity. The
    detector must run ``task="obb"`` (DetectionBatch.rboxes carries the
    predictions). Returns {"rbox_mAP@t": ...} per threshold.
    """
    records = []
    classes = set()
    for i in range(images.shape[0]):
        bgr = images[i][..., ::-1]
        batch = det.infer_batch(bgr[None])
        v = batch.valid[0]
        records.append((batch.rboxes[0][v], batch.conf[0][v],
                        batch.cls_id[0][v], gt_rboxes[i][gt_mask[i]],
                        gt_cls[i][gt_mask[i]]))
        classes.update(int(c) for c in np.unique(batch.cls_id[0][v]))
        classes.update(int(c) for c in np.unique(gt_cls[i][gt_mask[i]]))

    out = {}
    for thr in iou_thresholds:
        aps = []
        for c in sorted(classes):
            pb, pc_, gb = [], [], []
            for rb, conf, cls, grb, gcls in records:
                sel = cls == c
                pb.append(rb[sel])
                pc_.append(conf[sel])
                gb.append(grb[gcls == c])
            aps.append(average_precision_rboxes(pb, pc_, gb, thr))
        out[f"rbox_mAP@{thr:g}"] = float(np.mean(aps)) if aps else 0.0
    return out


def match_report(pred_boxes: np.ndarray, gt_boxes: np.ndarray,
                 iou_thres: float = 0.5) -> Dict[str, float]:
    """Greedy matched precision/recall for one image."""
    iou = _iou_matrix(np.asarray(pred_boxes), np.asarray(gt_boxes))
    matched = 0
    taken = np.zeros(iou.shape[1], bool)
    for i in range(iou.shape[0]):
        if iou.shape[1] == 0:
            break
        j = int(np.argmax(np.where(taken, -1.0, iou[i])))
        if iou[i, j] >= iou_thres and not taken[j]:
            taken[j] = True
            matched += 1
    n_pred, n_gt = iou.shape
    return {
        "precision": matched / n_pred if n_pred else 0.0,
        "recall": matched / n_gt if n_gt else 0.0,
        "matched": matched, "n_pred": n_pred, "n_gt": n_gt,
    }
