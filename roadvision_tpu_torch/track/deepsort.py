"""DeepSORT-style appearance re-identification — the port of
``roadvision_tpu/track/deepsort.py``.

With per-detection descriptors (the step's ``emb``), the association
score is IoU + ``app_weight`` · max(cos, 0) over pairs that pass the
motion gate (IoU ≥ ``iou_threshold``) or the rescue gate (cos ≥
``app_thresh`` and IoU ≥ ``rescue_iou``), accepted above 1e-6; cos is
``state.app @ emb.T``. Without descriptors it is SORT's association.
Confident detections only (conf ≥ new_track_thresh) start tracks.
"""
from __future__ import annotations

import torch

from .appearance import EMB_DIM, box_embeddings  # noqa: F401 (re-export)
from .ocsort import confident_new_track
from .sort import greedy_associate, make_sort_step
from .sort_tracker import SortTracker


def appearance_score(iou: torch.Tensor, app: torch.Tensor,
                     emb: torch.Tensor, iou_t: float, w_app: float,
                     cos_t: float, resc: float) -> torch.Tensor:
    """(..., T, D) fused motion + appearance score, 0 outside the gates,
    from the track memory ``app`` (..., T, E) and the descriptors ``emb``
    (..., D, E)."""
    cos = app @ emb.transpose(-1, -2)
    gate = (iou >= iou_t) | ((cos >= cos_t) & (iou >= resc))
    affinity = iou + w_app * torch.clamp(cos, min=0.0)
    return torch.where(gate, affinity, torch.zeros_like(affinity))


def make_deepsort_associate(iou_threshold: float, app_weight: float,
                            app_thresh: float, rescue_iou: float):
    """Appearance-augmented association strategy (make_sort_step hook)."""
    iou_t = float(iou_threshold)
    w_app = float(app_weight)
    cos_t = float(app_thresh)
    resc = float(rescue_iou)

    def associate(iou, alive, dvalid, conf, ctx):
        state, _boxes, _ts, emb = ctx
        if emb is None:
            return greedy_associate(iou, alive, dvalid, iou_t)
        score = appearance_score(iou, state.app, emb, iou_t, w_app, cos_t,
                                 resc)
        return greedy_associate(score, alive, dvalid, 1e-6)

    return associate


def make_deepsort_step(iou_threshold: float, max_staleness: float,
                       speed_window: float, app_weight: float = 0.5,
                       app_thresh: float = 0.6, rescue_iou: float = 0.02,
                       new_track_thresh: float = 0.6, nsa: bool = False):
    """The single-frame DeepSORT-style step; pass the descriptors as the
    trailing ``emb`` argument."""
    return make_sort_step(
        float(iou_threshold), float(max_staleness), float(speed_window),
        associate_fn=make_deepsort_associate(
            iou_threshold, app_weight, app_thresh, rescue_iou),
        new_track_fn=confident_new_track(new_track_thresh), nsa=nsa)


class DeepSortTracker(SortTracker):
    """Host-facing DeepSORT-style tracker with the list API. The list API
    carries no pixels, so it runs without descriptors, as in JAX (SORT's
    association with the re-id start policy)."""

    def _make_step(self, cfg: dict):
        return make_deepsort_step(
            self.iou_threshold, self.max_staleness, self.speed_window,
            app_weight=float(cfg.get("app_weight", 0.5)),
            app_thresh=float(cfg.get("app_thresh", 0.6)),
            rescue_iou=float(cfg.get("rescue_iou", 0.02)),
            new_track_thresh=float(cfg.get("new_track_thresh", 0.6)),
            nsa=self.nsa)
