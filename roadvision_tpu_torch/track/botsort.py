"""BoT-SORT-style two-stage association with a fused motion + appearance
cost — the port of ``roadvision_tpu/track/botsort.py``.

Stage 1 (high detections, all alive tracks): DeepSORT's fused score at
``match_iou`` (ByteTrack's IoU pass without descriptors); stage 2 (low
detections, the tracks stage 1 left): plain IoU at
``second_match_iou``. ByteTrack's start policy. Camera-motion
compensation is the orthogonal ``tracking.gmc`` knob.
"""
from __future__ import annotations

import torch

from .bytetrack import ByteTracker, high_new_track, taken_tracks
from .deepsort import appearance_score
from .sort import greedy_associate, make_sort_step


def make_botsort_associate(track_high_thresh: float,
                           track_low_thresh: float,
                           match_iou: float, second_match_iou: float,
                           app_weight: float, app_thresh: float,
                           rescue_iou: float):
    """Two-stage fused-cost association strategy (make_sort_step hook)."""
    hi_t = float(track_high_thresh)
    lo_t = float(track_low_thresh)
    iou1 = float(match_iou)
    iou2 = float(second_match_iou)
    w_app = float(app_weight)
    cos_t = float(app_thresh)
    resc = float(rescue_iou)

    def associate(iou, alive, dvalid, conf, ctx):
        state, _boxes, _ts, emb = ctx
        high = dvalid & (conf >= hi_t)
        low = dvalid & ~high & (conf >= lo_t)
        if emb is None:
            d2t_hi = greedy_associate(iou, alive, high, iou1)
        else:
            d2t_hi = greedy_associate(
                appearance_score(iou, state.app, emb, iou1, w_app, cos_t,
                                 resc), alive, high, 1e-6)
        taken_t = taken_tracks(d2t_hi, iou.shape[-2])
        d2t_lo = greedy_associate(iou, alive & ~taken_t, low, iou2)
        return torch.where(d2t_hi >= 0, d2t_hi, d2t_lo)

    return associate


def make_botsort_step(max_staleness: float, speed_window: float,
                      track_high_thresh: float = 0.5,
                      track_low_thresh: float = 0.1,
                      new_track_thresh: float = 0.6,
                      match_iou: float = 0.3,
                      second_match_iou: float = 0.5,
                      app_weight: float = 0.5,
                      app_thresh: float = 0.6,
                      rescue_iou: float = 0.02,
                      nsa: bool = False):
    """The single-frame BoT-SORT-style step; ``emb`` and ``shift`` as the
    trailing arguments."""
    return make_sort_step(
        0.0, max_staleness, speed_window,
        associate_fn=make_botsort_associate(
            track_high_thresh, track_low_thresh, match_iou,
            second_match_iou, app_weight, app_thresh, rescue_iou),
        new_track_fn=high_new_track(track_high_thresh, new_track_thresh),
        nsa=nsa)


class BotSortTracker(ByteTracker):
    """Host-facing BoT-SORT with the list API, without descriptors (stage
    1 is ByteTrack's IoU pass), as in JAX."""

    def _make_step(self, cfg: dict):
        return make_botsort_step(
            self.max_staleness, self.speed_window,
            track_high_thresh=self.track_high_thresh,
            track_low_thresh=self.track_low_thresh,
            new_track_thresh=self.new_track_thresh,
            match_iou=self.match_iou,
            second_match_iou=self.second_match_iou,
            app_weight=float(cfg.get("app_weight", 0.5)),
            app_thresh=float(cfg.get("app_thresh", 0.6)),
            rescue_iou=float(cfg.get("rescue_iou", 0.02)),
            nsa=self.nsa)
