"""OC-SORT-style observation-centric tracker — the port of
``roadvision_tpu/track/ocsort.py``.

* OCM: the association score is ``2 + IoU − vdc_weight · angle/π`` on
  pairs with predicted IoU ≥ ``iou_threshold`` (−1 elsewhere), the angle
  between the track's observed direction (previous → last observation
  centre) and last observation → detection; tracks need hits ≥ 2.
* OCR: detections left by stage 1 against the tracks it left, on the
  IoU of their LAST observations, at ``ocr_iou``.
* ORU: a re-activated track (hit_streak == 0) restarts from the
  posterior at its last observation and re-runs ``oru_steps`` virtual
  predict/update cycles along the z-space line to the new box, each with
  dt = gap / oru_steps (not clamped again).

Built from ``sort.make_sort_step``'s hooks; the step has SORT's
contract.
"""
from __future__ import annotations

import math

import torch

from .bytetrack import taken_tracks
from .sort import (_kf_predict, _kf_update, _take, bbox_to_z,
                   greedy_associate, iou_matrix, make_sort_step, nsa_r_scale)
from .sort_tracker import SortTracker, parse_common_cfg


def ocm_penalty(state, boxes: torch.Tensor,
                alive: torch.Tensor) -> torch.Tensor:
    """(..., T, D) velocity-direction penalty in [0, 1] (0 where a track
    has no direction yet or a detection sits on its last observation),
    over any leading stream axes of the state and ``boxes`` (..., D, 4)."""
    lc = 0.5 * (state.last_obs[..., :2] + state.last_obs[..., 2:])
    pc = 0.5 * (state.prev_obs[..., :2] + state.prev_obs[..., 2:])
    v = lc - pc
    vn = torch.hypot(v[..., 0], v[..., 1])
    has_v = alive & (state.hits >= 2) & (vn > 1e-6)
    dc = 0.5 * (boxes[..., :2] + boxes[..., 2:])
    dd = dc[..., None, :, :] - lc[..., :, None, :]
    dn = torch.hypot(dd[..., 0], dd[..., 1])
    cos = (v[..., :, None, 0] * dd[..., 0] + v[..., :, None, 1] * dd[..., 1]) \
        / torch.clamp(vn[..., None] * dn, min=1e-6)
    ang = torch.arccos(cos.clamp(-1.0, 1.0)) / math.pi
    return torch.where(has_v[..., None] & (dn > 1e-6), ang,
                       torch.zeros_like(ang))


def make_oc_associate(iou_threshold: float, vdc_weight: float,
                      ocr_iou: float, use_ocr: bool = True):
    """OCM + OCR association strategy (the make_sort_step hook)."""
    thr = float(iou_threshold)
    w = float(vdc_weight)
    if not 0.0 <= w < 2.0:
        raise ValueError(f"vdc_weight={w} out of range [0, 2): the score "
                         f"shift guarantees accepted scores stay positive "
                         f"only for weights below 2")
    thr2 = float(ocr_iou)

    def associate(iou, alive, dvalid, conf, ctx):
        state, boxes, _ts, _emb = ctx
        pen = ocm_penalty(state, boxes, alive)
        score = torch.where(iou >= thr, 2.0 + iou - w * pen,
                            torch.full_like(iou, -1.0))
        d2t = greedy_associate(score, alive, dvalid, 0.0)
        if not use_ocr:
            return d2t
        taken_t = taken_tracks(d2t, iou.shape[-2])
        rem_d = dvalid & (d2t < 0)
        iou_obs = iou_matrix(state.last_obs, boxes)
        d2t2 = greedy_associate(iou_obs, alive & ~taken_t, rem_d, thr2)
        return torch.where(d2t >= 0, d2t, d2t2)

    return associate


def make_oru_update(oru_steps: int, nsa: bool = False):
    """ORU measurement-update strategy (the make_sort_step hook)."""
    k_steps = int(oru_steps)
    use_nsa = bool(nsa)

    def update(state, boxes, det_idx, matched_t, ts, conf):
        scale = nsa_r_scale(torch.gather(conf, -1, det_idx)) if use_nsa \
            else None
        z_new = _take(bbox_to_z(boxes), det_idx)
        umean, ucov = _kf_update(state.mean, state.cov, z_new, scale)
        if k_steps <= 0:
            return umean, ucov
        reactivated = matched_t & (state.hit_streak == 0)
        gap = torch.clamp(ts[..., None] - state.last_obs_ts, min=1e-3)
        dt_k = gap / k_steps                              # NOT re-clamped
        z_last = bbox_to_z(state.last_obs)
        mean, cov = state.obs_mean, state.obs_cov
        for k in range(k_steps):
            zk = z_last + (k + 1.0) / k_steps * (z_new - z_last)
            pm, pc = _kf_predict(mean, cov, dt_k)
            mean, cov = _kf_update(pm, pc, zk, scale)
        return (torch.where(reactivated[..., None], mean, umean),
                torch.where(reactivated[..., None, None], cov, ucov))

    return update


def confident_new_track(new_track_thresh: float):
    """Unmatched detections with conf ≥ new_track_thresh start tracks."""
    new_t = float(new_track_thresh)

    def new_track(dvalid, matched_d, conf):
        return dvalid & ~matched_d & (conf >= new_t)

    return new_track


def make_oc_step(iou_threshold: float, max_staleness: float,
                 speed_window: float, vdc_weight: float = 0.2,
                 ocr_iou: float = None, use_ocr: bool = True,
                 oru_steps: int = 4, new_track_thresh: float = 0.6,
                 nsa: bool = False):
    """The single-frame OC-SORT step, with SORT's step contract."""
    return make_sort_step(
        float(iou_threshold), float(max_staleness), float(speed_window),
        associate_fn=make_oc_associate(
            iou_threshold, vdc_weight,
            iou_threshold if ocr_iou is None else ocr_iou, use_ocr),
        new_track_fn=confident_new_track(new_track_thresh),
        update_fn=make_oru_update(oru_steps, nsa=nsa))


class OcSortTracker(SortTracker):
    """Host-facing OC-SORT with the list API."""

    def _parse(self, cfg: dict) -> None:
        parse_common_cfg(self, cfg)
        self.vdc_weight = float(cfg.get("vdc_weight", 0.2))
        ocr = cfg.get("ocr_iou")
        self.ocr_iou = float(ocr) if ocr is not None else self.iou_threshold
        self.use_ocr = bool(cfg.get("use_ocr", True))
        self.oru_steps = int(cfg.get("oru_steps", 4))
        self.new_track_thresh = float(cfg.get("new_track_thresh", 0.6))

    def _make_step(self, cfg: dict):
        return make_oc_step(
            self.iou_threshold, self.max_staleness, self.speed_window,
            vdc_weight=self.vdc_weight, ocr_iou=self.ocr_iou,
            use_ocr=self.use_ocr, oru_steps=self.oru_steps,
            new_track_thresh=self.new_track_thresh, nsa=self.nsa)
