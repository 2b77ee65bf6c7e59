"""Tracking-quality metrics: MOTA (CLEAR-MOT), IDF1, HOTA — a copy of
``roadvision_tpu/track/eval.py`` (host numpy plus one scipy assignment
per frame; the ``tools/track.py --gt`` report).

Greedy IoU matching of tracker output against ground-truth identities
per frame, accumulating misses, false positives and identity switches
(CLEAR-MOT at one operating point), plus IDF1 (Ristani et al. 2016:
globally optimal trajectory pairing) and HOTA (Luiten et al. 2021:
detection/association decomposition averaged over localization
thresholds, the TrackEval accounting).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def evaluate_tracking(
    frames_gt: Sequence[Sequence[Tuple[float, float, float, float, int]]],
    frames_pred: Sequence[Sequence[Tuple[float, float, float, float, int]]],
    iou_thres: float = 0.5,
) -> Dict[str, float]:
    """frames_gt[f] = [(x1,y1,x2,y2,gt_id)], frames_pred likewise with
    track ids. Returns mota, id_switches, misses, false_positives,
    matches."""
    last_match: Dict[int, int] = {}  # gt_id -> track_id
    misses = fps = switches = matches = total_gt = 0
    for gts, preds in zip(frames_gt, frames_pred):
        total_gt += len(gts)
        taken = [False] * len(preds)
        for (gx1, gy1, gx2, gy2, gid) in gts:
            best, best_iou = -1, iou_thres
            for i, (px1, py1, px2, py2, tid) in enumerate(preds):
                if taken[i]:
                    continue
                v = _iou((gx1, gy1, gx2, gy2), (px1, py1, px2, py2))
                if v >= best_iou:
                    best, best_iou = i, v
            if best < 0:
                misses += 1
                continue
            taken[best] = True
            matches += 1
            tid = preds[best][4]
            if gid in last_match and last_match[gid] != tid:
                switches += 1
            last_match[gid] = tid
        fps += sum(1 for t in taken if not t)
    mota = 1.0 - (misses + fps + switches) / max(1, total_gt)
    return {"mota": mota, "id_switches": switches, "misses": misses,
            "false_positives": fps, "matches": matches,
            "total_gt": total_gt}


def _frames_to_arrays(frames):
    """[(x1,y1,x2,y2,id), ...] per frame → (boxes (N,4) f64, ids (N,))."""
    out = []
    for rows in frames:
        if len(rows):
            a = np.asarray(rows, np.float64)
            out.append((a[:, :4], a[:, 4].astype(np.int64)))
        else:
            out.append((np.zeros((0, 4)), np.zeros((0,), np.int64)))
    return out


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(G, 4) × (P, 4) xyxy → (G, P) IoU."""
    if not len(a) or not len(b):
        return np.zeros((len(a), len(b)))
    ix = np.maximum(0.0, np.minimum(a[:, None, 2], b[None, :, 2])
                    - np.maximum(a[:, None, 0], b[None, :, 0]))
    iy = np.maximum(0.0, np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 1], b[None, :, 1]))
    inter = ix * iy
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _id_index(frames):
    """Stable id → contiguous index over a whole sequence."""
    ids: Dict[int, int] = {}
    for _, fids in frames:
        for i in fids:
            ids.setdefault(int(i), len(ids))
    return ids


def evaluate_idf1(
    frames_gt: Sequence[Sequence[Tuple[float, float, float, float, int]]],
    frames_pred: Sequence[Sequence[Tuple[float, float, float, float, int]]],
    iou_thres: float = 0.5,
) -> Dict[str, float]:
    """IDF1 (Ristani et al. 2016): pair WHOLE gt and predicted
    trajectories 1-1 to maximize the number of frames where the paired
    identities' boxes coincide (IoU ≥ ``iou_thres``); IDTP is that
    maximum, IDF1 = 2·IDTP / (total_gt + total_pred)."""
    from scipy.optimize import linear_sum_assignment

    gt = _frames_to_arrays(frames_gt)
    pr = _frames_to_arrays(frames_pred)
    gt_idx = _id_index(gt)
    pr_idx = _id_index(pr)
    total_gt = sum(len(ids) for _, ids in gt)
    total_pr = sum(len(ids) for _, ids in pr)
    if not gt_idx or not pr_idx:
        idtp = 0
    else:
        # frames where trajectory pair (g, p) could be matched
        overlap = np.zeros((len(gt_idx), len(pr_idx)), np.int64)
        for (gb, gi), (pb, pi) in zip(gt, pr):
            hit = _iou_matrix(gb, pb) >= iou_thres
            for r, c in zip(*np.nonzero(hit)):
                overlap[gt_idx[int(gi[r])], pr_idx[int(pi[c])]] += 1
        rows, cols = linear_sum_assignment(-overlap)
        idtp = int(overlap[rows, cols].sum())
    denom = total_gt + total_pr
    return {"idf1": (2.0 * idtp / denom) if denom else 1.0,
            "idtp": idtp, "idfn": total_gt - idtp,
            "idfp": total_pr - idtp}


def evaluate_hota(
    frames_gt: Sequence[Sequence[Tuple[float, float, float, float, int]]],
    frames_pred: Sequence[Sequence[Tuple[float, float, float, float, int]]],
    alphas: Sequence[float] = tuple(np.arange(0.05, 0.96, 0.05)),
) -> Dict[str, float]:
    """HOTA (Luiten et al. 2021), the TrackEval accounting: per
    localization threshold α, match per frame with Hungarian on the
    global trajectory-alignment score (Jaccard of potential matches),
    then DetA = TP/(TP+FN+FP), AssA = TP-weighted mean of per-pair
    association Jaccard, HOTA_α = sqrt(DetA·AssA); report the mean over
    α plus the α=0.5-ish midpoint components."""
    from scipy.optimize import linear_sum_assignment

    gt = _frames_to_arrays(frames_gt)
    pr = _frames_to_arrays(frames_pred)
    gt_idx = _id_index(gt)
    pr_idx = _id_index(pr)
    n_g, n_p = len(gt_idx), len(pr_idx)
    total_gt = sum(len(ids) for _, ids in gt)
    total_pr = sum(len(ids) for _, ids in pr)
    gt_count = np.zeros(n_g)
    pr_count = np.zeros(n_p)
    sims = []                       # per-frame (iou, gidx, pidx)
    for (gb, gi), (pb, pi) in zip(gt, pr):
        for i in gi:
            gt_count[gt_idx[int(i)]] += 1
        for i in pi:
            pr_count[pr_idx[int(i)]] += 1
        sims.append((_iou_matrix(gb, pb),
                     np.asarray([gt_idx[int(i)] for i in gi], np.int64),
                     np.asarray([pr_idx[int(i)] for i in pi], np.int64)))

    if total_gt == 0 and total_pr == 0:
        return {"hota": 1.0, "deta": 1.0, "assa": 1.0}
    if n_g == 0 or n_p == 0:
        return {"hota": 0.0, "deta": 0.0, "assa": 0.0}

    hotas, detas, assas = [], [], []
    for alpha in alphas:
        # pass 1: potential per-pair matches at this α
        potential = np.zeros((n_g, n_p))
        for iou, gix, pix in sims:
            hit = iou >= alpha - 1e-9
            for r, c in zip(*np.nonzero(hit)):
                potential[gix[r], pix[c]] += 1
        align = potential / np.maximum(
            gt_count[:, None] + pr_count[None, :] - potential, 1e-12)
        # pass 2: per-frame Hungarian on the global alignment score
        matches = np.zeros((n_g, n_p))
        tp = 0
        for iou, gix, pix in sims:
            if not len(gix) or not len(pix):
                continue
            valid = iou >= alpha - 1e-9
            score = align[np.ix_(gix, pix)] * valid
            rows, cols = linear_sum_assignment(-score)
            for r, c in zip(rows, cols):
                if valid[r, c]:
                    matches[gix[r], pix[c]] += 1
                    tp += 1
        fn = total_gt - tp
        fp = total_pr - tp
        deta = tp / max(tp + fn + fp, 1e-12)
        pair_ass = matches / np.maximum(
            gt_count[:, None] + pr_count[None, :] - matches, 1e-12)
        assa = float((matches * pair_ass).sum() / max(tp, 1e-12))
        detas.append(deta)
        assas.append(assa)
        hotas.append(float(np.sqrt(deta * assa)))
    return {"hota": float(np.mean(hotas)),
            "deta": float(np.mean(detas)),
            "assa": float(np.mean(assas))}


def evaluate_all(frames_gt, frames_pred,
                 iou_thres: float = 0.5) -> Dict[str, float]:
    """MOTA + IDF1 + HOTA in one call (the tools/track.py --gt report)."""
    out = evaluate_tracking(frames_gt, frames_pred, iou_thres)
    out.update(evaluate_idf1(frames_gt, frames_pred, iou_thres))
    out.update(evaluate_hota(frames_gt, frames_pred))
    return out
