"""ByteTrack-style two-stage association — the port of
``roadvision_tpu/track/bytetrack.py``.

High detections (conf ≥ track_high_thresh) are matched greedily against
every alive track at ``match_iou``; low ones (track_low_thresh ≤ conf <
track_high_thresh) against the tracks stage 1 left at
``second_match_iou``. Only unmatched high detections with conf ≥
new_track_thresh start tracks. Built from ``sort.make_sort_step``'s
hooks, so the step has SORT's contract.
"""
from __future__ import annotations

import torch

from .sort import greedy_associate, make_sort_step
from .sort_tracker import SortTracker, parse_common_cfg


def taken_tracks(d2t: torch.Tensor, num_t: int) -> torch.Tensor:
    """(..., T) bool: the tracks a det→track map (..., D) took (entry T
    of each row takes the unmatched detections, then goes away)."""
    taken = torch.zeros(d2t.shape[:-1] + (num_t + 1,), dtype=torch.bool,
                        device=d2t.device)
    taken.scatter_(-1, torch.where(d2t >= 0, d2t, num_t).long(), True)
    return taken[..., :num_t]


def make_byte_associate(track_high_thresh: float, track_low_thresh: float,
                        match_iou: float, second_match_iou: float):
    """Two-stage association strategy (the make_sort_step hook)."""
    hi_t = float(track_high_thresh)
    lo_t = float(track_low_thresh)
    iou1 = float(match_iou)
    iou2 = float(second_match_iou)

    def associate(iou, alive, dvalid, conf, ctx):
        high = dvalid & (conf >= hi_t)
        low = dvalid & ~high & (conf >= lo_t)
        d2t_hi = greedy_associate(iou, alive, high, iou1)
        taken_t = taken_tracks(d2t_hi, iou.shape[-2])
        d2t_lo = greedy_associate(iou, alive & ~taken_t, low, iou2)
        return torch.where(d2t_hi >= 0, d2t_hi, d2t_lo)

    return associate


def high_new_track(track_high_thresh: float, new_track_thresh: float):
    """Only unmatched HIGH detections above the start threshold start
    tracks; low detections never do (the ByteTrack invariant)."""
    hi_t, new_t = float(track_high_thresh), float(new_track_thresh)

    def new_track(dvalid, matched_d, conf):
        return dvalid & ~matched_d & (conf >= hi_t) & (conf >= new_t)

    return new_track


def make_byte_step(max_staleness: float, speed_window: float,
                   track_high_thresh: float = 0.5,
                   track_low_thresh: float = 0.1,
                   new_track_thresh: float = 0.6,
                   match_iou: float = 0.3,
                   second_match_iou: float = 0.5,
                   nsa: bool = False):
    """The single-frame ByteTrack step, with SORT's step contract."""
    return make_sort_step(
        0.0, max_staleness, speed_window,
        associate_fn=make_byte_associate(track_high_thresh, track_low_thresh,
                                         match_iou, second_match_iou),
        new_track_fn=high_new_track(track_high_thresh, new_track_thresh),
        nsa=nsa)


class ByteTracker(SortTracker):
    """Host-facing ByteTrack with the list API; unmatched low detections
    come back with ``track_id=None``."""

    def _parse(self, cfg: dict) -> None:
        parse_common_cfg(self, cfg)
        self.track_high_thresh = float(cfg.get("track_high_thresh", 0.5))
        self.track_low_thresh = float(cfg.get("track_low_thresh", 0.1))
        self.new_track_thresh = float(cfg.get("new_track_thresh", 0.6))
        # match_iou falls back to the SORT key, as in JAX
        self.match_iou = float(cfg.get("match_iou",
                                       cfg.get("iou_threshold", 0.3)))
        self.second_match_iou = float(cfg.get("second_match_iou", 0.5))

    def _make_step(self, cfg: dict):
        return make_byte_step(
            self.max_staleness, self.speed_window,
            track_high_thresh=self.track_high_thresh,
            track_low_thresh=self.track_low_thresh,
            new_track_thresh=self.new_track_thresh,
            match_iou=self.match_iou,
            second_match_iou=self.second_match_iou, nsa=self.nsa)
