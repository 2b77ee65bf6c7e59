"""SORT multi-object tracking on tensors — the port of
``roadvision_tpu/track/sort_tpu.py`` (greedy and ε-auction association,
the strategy hooks the other trackers are built from).

A fixed-capacity slot array (:class:`SortState`) carries every track;
one :func:`make_sort_step` call runs a frame: Kalman predict of alive
tracks, IoU of predicted boxes against detections, greedy association,
Joseph-form Kalman update, ground-plane metrics with the speed-history
window, staleness pruning, and new tracks for unmatched detections. The
reference's quirks, as listed in the docstring at sort_tpu.py:10-41, are
kept:

  * z = [cx, cy, s=w·h, r=w/h] with w/h floored at 1e-3; inverse with
    1e-6 floors; R = diag(1,1,10,10); P₀ = diag(10,10,10,10,1e4,1e4,1e4);
  * real-timestamp dt ≥ 1e-3, F[0,4]=F[1,5]=F[2,6]=dt,
    Q = diag(.04dt², .04dt², .04dt², 0, dt, dt, dt);
  * greedy global-argmax association with first-flat-index ties, accept
    while max ≥ iou_threshold (computed as mutual-maximum rounds, which
    give the sequential result exactly);
  * every unmatched detection gets a track and an id at once, ids from 1
    in detection order; min_hits never gates output;
  * unmatched tracks only reset hit_streak; prune when
    ts − last_update_ts > max_staleness (before creation);
  * metrics from the DET box's bottom centre, distance clamped, a
    32-entry history windowed by speed_window seconds, speed =
    first→last displacement / elapsed (≥ 1e-3 s) × 3.6 km/h;
  * overflow beyond the slot count keeps id assignment but drops tracks.

The association rounds read one flag back to the host per round (JAX
runs them as a device ``while_loop``); the ε-auction reads one flag per
block of :data:`AUCTION_BLOCK` rounds. Every such read adds one to
:data:`host_syncs` so a caller can count them per batch.
``nsa=True`` is the NSA Kalman of StrongSORT: measurement noise scaled
per track by ``1 − conf`` (:func:`nsa_r_scale`).

:class:`SortState` holds the JAX state's 25 fields in the JAX order: the
18 of SORT, the observation memory the observation-centric strategies
read (``last_obs``, ``prev_obs`` and their stamps, the posterior at the
last observation) and the appearance memory of the re-id strategies
(``app``, an EMA of the matched descriptors, renormalised).
:func:`make_sort_step`'s hooks (``associate_fn``, ``new_track_fn``,
``update_fn``) and its trailing ``emb`` / ``shift`` arguments are the
JAX step's (sort_tpu.py:396-650).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device

HISTORY = 32
STATE_DIM = 7
MEAS_DIM = 4
# appearance-descriptor width (track/appearance.py); checked against
# appearance.EMB_DIM at import so a change to one cannot surface as a
# shape error inside the step
_EMB_DIM = 108
APP_EMA = 0.9          # matched-track appearance EMA factor
AUCTION_BLOCK = 8      # ε-auction rounds between two reads of "done"
# reads of a device flag by the association loops since the last reset
host_syncs = 0


def _check_emb_dim() -> None:
    from .appearance import EMB_DIM
    assert EMB_DIM == _EMB_DIM, (
        f"appearance.EMB_DIM={EMB_DIM} != sort._EMB_DIM={_EMB_DIM}: "
        f"update both (SortState.app width must match the descriptor)")


def reset_host_syncs() -> None:
    global host_syncs
    host_syncs = 0


def read_flag(flag: torch.Tensor) -> bool:
    """One device flag read on the host, counted in :data:`host_syncs`."""
    global host_syncs
    host_syncs += 1
    return bool(flag)

_R_DIAG = (1.0, 1.0, 10.0, 10.0)
_P0_DIAG = (10.0, 10.0, 10.0, 10.0, 1e4, 1e4, 1e4)


class SortState(NamedTuple):
    mean: torch.Tensor        # (T, 7) f32
    cov: torch.Tensor         # (T, 7, 7) f32
    alive: torch.Tensor       # (T,) bool
    ids: torch.Tensor         # (T,) i32
    last_predict_ts: torch.Tensor   # (T,) f32
    last_update_ts: torch.Tensor    # (T,) f32
    hits: torch.Tensor        # (T,) i32
    hit_streak: torch.Tensor  # (T,) i32
    cls_id: torch.Tensor      # (T,) i32
    conf: torch.Tensor        # (T,) f32
    dist: torch.Tensor        # (T,) f32 (NaN = None)
    speed: torch.Tensor       # (T,) f32 m/s (NaN = None)
    hist_ts: torch.Tensor     # (T, 32) f32 ring buffer
    hist_x: torch.Tensor      # (T, 32) f32
    hist_y: torch.Tensor      # (T, 32) f32
    hist_head: torch.Tensor   # (T,) i32
    hist_len: torch.Tensor    # (T,) i32
    next_id: torch.Tensor     # () i32
    # observation memory (every backend keeps it; ocsort.py reads it)
    last_obs: torch.Tensor    # (T, 4) f32 xyxy of the last observation
    last_obs_ts: torch.Tensor  # (T,) f32
    prev_obs: torch.Tensor    # (T, 4) f32 the observation before that
    prev_obs_ts: torch.Tensor  # (T,) f32
    obs_mean: torch.Tensor    # (T, 7) f32 KF posterior at last observation
    obs_cov: torch.Tensor     # (T, 7, 7) f32
    # appearance memory (kept when the step gets descriptors)
    app: torch.Tensor         # (T, appearance.EMB_DIM) f32


class SortOutput(NamedTuple):
    track_id: torch.Tensor    # (D,) i32 (0 = no id / invalid det)
    distance_m: torch.Tensor  # (D,) f32 (NaN = None)
    speed_kmh: torch.Tensor   # (D,) f32 (NaN = None)


def _p0(device) -> torch.Tensor:
    return torch.diag(torch.tensor(_P0_DIAG, dtype=torch.float32,
                                   device=device))


def init_state(num_slots: int, device=None) -> SortState:
    """Empty track slots on ``device``: the card unless the caller names
    another (``device="cpu"`` for the plain path)."""
    device = resolve_device(device)
    t = num_slots
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    nan = torch.full((t,), float("nan"), dtype=f32, device=device)
    return SortState(
        mean=z(t, STATE_DIM), cov=_p0(device).repeat(t, 1, 1),
        alive=z(t, dtype=torch.bool), ids=z(t, dtype=i32),
        last_predict_ts=z(t), last_update_ts=z(t),
        hits=z(t, dtype=i32), hit_streak=z(t, dtype=i32),
        cls_id=z(t, dtype=i32), conf=z(t), dist=nan.clone(), speed=nan,
        hist_ts=z(t, HISTORY), hist_x=z(t, HISTORY), hist_y=z(t, HISTORY),
        hist_head=z(t, dtype=i32), hist_len=z(t, dtype=i32),
        next_id=torch.ones((), dtype=i32, device=device),
        last_obs=z(t, MEAS_DIM), last_obs_ts=z(t),
        prev_obs=z(t, MEAS_DIM), prev_obs_ts=z(t),
        obs_mean=z(t, STATE_DIM), obs_cov=_p0(device).repeat(t, 1, 1),
        app=z(t, _EMB_DIM))


def bbox_to_z(boxes: torch.Tensor) -> torch.Tensor:
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-3)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-3)
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    return torch.stack([cx, cy, w * h, w / h], dim=-1)


def x_to_bbox(mean: torch.Tensor) -> torch.Tensor:
    cx, cy, s, r = mean[..., 0], mean[..., 1], mean[..., 2], mean[..., 3]
    w = torch.sqrt(torch.clamp(s * r, min=1e-6))
    h = s / torch.clamp(w, min=1e-6)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (Ta, 4) × (Db, 4) → (Ta, Db); degenerate → 0."""
    ax1, ay1, ax2, ay2 = (a[:, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[None, :, i] for i in range(4))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0.0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp(min=0.0) * (ay2 - ay1).clamp(min=0.0)
    area_b = (bx2 - bx1).clamp(min=0.0) * (by2 - by1).clamp(min=0.0)
    denom = area_a + area_b - inter
    ok = denom > 0.0
    return torch.where(ok, inter / torch.where(ok, denom,
                                               torch.ones_like(denom)),
                       torch.zeros_like(denom))


def greedy_associate(iou: torch.Tensor, alive: torch.Tensor,
                     dvalid: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy global-argmax matching → det→track (D,) int32, -1 unmatched,
    by mutual-maximum rounds (sort_tpu.py:186-230)."""
    num_t, num_d = iou.shape
    dev = iou.device
    mat = torch.where(alive[:, None] & dvalid[None, :], iou,
                      torch.full_like(iou, -1.0))
    t_ids = torch.arange(num_t, dtype=torch.int32, device=dev)
    det2trk = torch.full((num_d,), -1, dtype=torch.int32, device=dev)
    for _ in range(min(num_t, num_d) + 1):
        rbest = mat.argmax(dim=1)
        cbest = mat.argmax(dim=0)
        rval = mat.max(dim=1).values
        mutual = (cbest[rbest].to(torch.int32) == t_ids) \
            & (rval >= thresh) & (rval > -0.5)
        if not read_flag(mutual.any()):
            break
        t_for_d = torch.full((num_d,), -1, dtype=torch.int32, device=dev) \
            .scatter_reduce(0, rbest, torch.where(mutual, t_ids, -1),
                            reduce="amax")
        taken_d = torch.zeros((num_d,), dtype=torch.int32, device=dev) \
            .scatter_reduce(0, rbest, mutual.to(torch.int32),
                            reduce="amax") > 0
        det2trk = torch.where(taken_d & (det2trk < 0), t_for_d, det2trk)
        mat = torch.where(mutual[:, None] | taken_d[None, :],
                          torch.full_like(mat, -1.0), mat)
    return det2trk


def auction_associate(iou: torch.Tensor, alive: torch.Tensor,
                      dvalid: torch.Tensor, thresh: float,
                      eps: float = 0.01, max_iters: int = 512
                      ) -> torch.Tensor:
    """Optimal-assignment association (``association: hungarian``) by
    the parallel ε-auction of sort_tpu.py:233-311: every unassigned
    valid detection bids ``best − second best + ε`` for its best-value
    column, each column goes to its highest bidder (first index on
    ties); D dummy columns at −1 let every detection end assigned; pairs
    on a dummy column or below ``thresh`` are unmatched afterwards.
    Returns det→track (D,) int32, -1 unmatched.

    JAX runs the rounds as a device ``while_loop`` that stops when no
    valid detection is unassigned or after ``max_iters`` rounds. Here
    the rounds run in blocks of :data:`AUCTION_BLOCK` with one read of
    that flag per block. This is exact: once every valid detection is
    assigned, nobody bids, so a further round changes neither prices nor
    assignments (``has_bid`` is false everywhere, hence no eviction and
    no win); and ``max_iters`` is cut at the same round count, the last
    block shortened if needed."""
    num_t, num_d = iou.shape
    dev = iou.device
    neg = -1e9
    cols = num_t + num_d
    col_ids = torch.arange(cols, device=dev)
    det_ids = torch.arange(num_d, device=dev)
    w_real = torch.where(alive[:, None] & dvalid[None, :], iou,
                         torch.full_like(iou, neg)).T
    w = torch.cat([w_real, torch.full((num_d, num_d), -1.0,
                                      dtype=torch.float32, device=dev)],
                  dim=1)
    prices = torch.zeros((cols,), dtype=torch.float32, device=dev)
    assigned = torch.full((num_d,), -1, dtype=torch.int64, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)

    def round_(prices, assigned):
        values = w - prices[None, :]
        best_c = values.argmax(dim=1)
        v1 = values.max(dim=1).values
        rest = values.clone()
        rest[det_ids, best_c] = neg
        v2 = rest.max(dim=1).values
        bidding = (assigned < 0) & dvalid
        incr = v1 - v2 + eps
        bid_mat = torch.where(
            bidding[:, None] & (best_c[:, None] == col_ids[None, :]),
            incr[:, None], neg_inf)
        top_bid = bid_mat.max(dim=0).values
        winner = bid_mat.argmax(dim=0)
        has_bid = top_bid > float("-inf")
        prices = torch.where(has_bid, prices + top_bid, prices)
        own_c = assigned.clamp(0, cols - 1)
        evicted = (assigned >= 0) & has_bid[own_c] \
            & (winner[own_c] != det_ids)
        assigned = torch.where(evicted, -1, assigned)
        won = bidding & has_bid[best_c] & (winner[best_c] == det_ids)
        assigned = torch.where(won, best_c, assigned)
        return prices, assigned

    it = 0
    while it < max_iters and read_flag((dvalid & (assigned < 0)).any()):
        for _ in range(min(AUCTION_BLOCK, max_iters - it)):
            prices, assigned = round_(prices, assigned)
        it += AUCTION_BLOCK

    real = (assigned >= 0) & (assigned < num_t)
    trk = assigned.clamp(0, num_t - 1)
    good = real & (iou.T[det_ids, trk] >= thresh) & alive[trk] & dvalid
    return torch.where(good, trk, -1).to(torch.int32)


def _kf_predict(mean, cov, dt):
    t = mean.shape[0]
    dev = mean.device
    f = torch.eye(STATE_DIM, device=dev).repeat(t, 1, 1)
    for i, j in ((0, 4), (1, 5), (2, 6)):
        f[:, i, j] = dt
    q = 0.04 * dt * dt
    zero = torch.zeros_like(dt)
    q_diag = torch.stack([q, q, q, zero, dt, dt, dt], dim=-1)
    new_mean = torch.einsum("tij,tj->ti", f, mean)
    new_cov = torch.einsum("tij,tjk,tlk->til", f, cov, f) \
        + torch.diag_embed(q_diag)
    return new_mean, new_cov


def nsa_r_scale(conf: torch.Tensor) -> torch.Tensor:
    """NSA measurement-noise scale (1 − conf), floored at 1e-3 so that R
    stays positive definite at conf → 1."""
    return torch.clamp(1.0 - conf, min=1e-3)


def _kf_update(mean, cov, z, r_scale=None):
    """Batched KF update, H = [I4 0], Joseph-form covariance (filterpy).
    ``r_scale`` (T,) scales the measurement noise per track (NSA)."""
    t = mean.shape[0]
    dev = mean.device
    r = torch.diag(torch.tensor(_R_DIAG, dtype=torch.float32, device=dev))
    if r_scale is None:
        r = r.expand(t, MEAS_DIM, MEAS_DIM)
    else:
        r = r_scale[:, None, None] * r[None]
    ph = cov[:, :, :MEAS_DIM]
    s = cov[:, :MEAS_DIM, :MEAS_DIM] + r
    k = torch.linalg.solve(s, ph.transpose(1, 2)).transpose(1, 2)
    innov = z - mean[:, :MEAS_DIM]
    new_mean = mean + torch.einsum("tij,tj->ti", k, innov)
    kh = torch.zeros_like(cov)
    kh[:, :, :MEAS_DIM] = k
    i_kh = torch.eye(STATE_DIM, device=dev)[None] - kh
    new_cov = torch.einsum("tij,tjk,tlk->til", i_kh, cov, i_kh) \
        + torch.einsum("tij,tjk,tlk->til", k, r, k)
    return new_mean, new_cov


def _history_append_and_window(state: SortState, sel, ts, gx, gy, window):
    t_slots = state.hist_ts.shape[0]
    dev = sel.device
    head, length = state.hist_head, state.hist_len
    full = length >= HISTORY
    write_pos = ((head + length) % HISTORY).long()
    head_after = torch.where(sel & full, (head + 1) % HISTORY, head)
    len_after = torch.where(sel & ~full, length + 1, length)

    rows = torch.arange(t_slots, device=dev)

    def put(buf, val):
        buf = buf.clone()
        buf[rows, write_pos] = torch.where(sel, val, buf[rows, write_pos])
        return buf

    hist_ts = put(state.hist_ts, ts.expand(t_slots))
    hist_x = put(state.hist_x, gx)
    hist_y = put(state.hist_y, gy)

    slot = torch.arange(HISTORY, device=dev)[None, :]
    order = (slot - head_after[:, None]) % HISTORY
    in_buf = order < len_after[:, None]
    expired = in_buf & ((ts - hist_ts) > window)
    n_exp = expired.sum(dim=-1).to(torch.int32)
    head_new = torch.where(sel, (head_after + n_exp) % HISTORY, head_after)
    len_new = torch.where(sel, len_after - n_exp, len_after)

    first = head_new.long()
    last = ((head_new + torch.clamp(len_new - 1, min=0)) % HISTORY).long()
    t0 = hist_ts[rows, first]
    t1 = hist_ts[rows, last]
    dx = hist_x[rows, last] - hist_x[rows, first]
    dy = hist_y[rows, last] - hist_y[rows, first]
    spd = torch.hypot(dx, dy) / torch.clamp(t1 - t0, min=1e-3)
    speed = torch.where(len_new >= 2, spd, torch.full_like(spd, float("nan")))
    return state._replace(hist_ts=hist_ts, hist_x=hist_x, hist_y=hist_y,
                          hist_head=head_new.to(torch.int32),
                          hist_len=len_new.to(torch.int32)), speed


def _put_rows(buf: torch.Tensor, index: torch.Tensor, values) -> torch.Tensor:
    """``buf.at[index].set(values, mode="drop")`` for index in [0, T]: row
    T is a scratch row that takes the dropped writes, then goes away."""
    ext = torch.cat([buf, buf[:1]], dim=0)
    ext[index] = values if torch.is_tensor(values) else \
        torch.as_tensor(values, dtype=buf.dtype, device=buf.device)
    return ext[:-1]


def make_sort_step(iou_threshold: float, max_staleness: float,
                   speed_window: float, min_hits: int = 3,
                   association: str = "greedy",
                   associate_fn=None, new_track_fn=None, update_fn=None,
                   nsa: bool = False):
    """``step(state, boxes (D,4), cls (D,), conf (D,), dvalid (D,), ts (),
    proj, emb=None, shift=None) -> (state', SortOutput)``; proj is None
    or (H, origin, maxd); ``emb`` (D, EMB_DIM) per-detection descriptors
    (kept in ``state.app`` and handed to ``associate_fn``); ``shift``
    (2,) the camera's translation in source px since the previous frame
    (track/gmc.py), applied to the position memory before the predict.

    ``association``: "greedy" (the reference) or "hungarian" (the
    ε-auction, :func:`auction_associate`). The hooks, as in JAX:
    ``associate_fn(iou (T,D), alive, dvalid, conf, ctx) → det→track``
    with ``ctx = (state, boxes, ts, emb)`` after the predict (replaces
    the association); ``new_track_fn(dvalid, matched_d, conf) → (D,)``
    bool (who starts a track); ``update_fn(state, boxes, det_idx (T,),
    matched_t (T,), ts, conf) → (mean, cov)`` (the measurement update;
    rows of unmatched tracks are ignored). ``nsa`` turns on the
    confidence-scaled measurement noise of the default update."""
    thresh = float(iou_threshold)
    staleness = float(max_staleness)
    window = max(0.05, float(speed_window))
    del min_hits   # tracked by the reference but never gates output
    if associate_fn is None:
        if association not in ("greedy", "hungarian"):
            raise ValueError(f"unknown association: {association!r} "
                             f"(expected 'greedy' or 'hungarian')")
        base_assoc = greedy_associate if association == "greedy" \
            else auction_associate

        def associate_fn(iou, alive, dvalid, conf, ctx):
            return base_assoc(iou, alive, dvalid, thresh)
    if new_track_fn is None:
        def new_track_fn(dvalid, matched_d, conf):
            return dvalid & ~matched_d
    use_nsa = bool(nsa)
    if update_fn is None:
        def update_fn(state, boxes, det_idx, matched_t, ts, conf):
            return _kf_update(state.mean, state.cov, bbox_to_z(boxes)[det_idx],
                              nsa_r_scale(conf[det_idx]) if use_nsa else None)

    from ..geometry.projector import project_boxes_device

    def step(state: SortState, boxes, cls_id, conf, dvalid, ts, proj=None,
             emb=None, shift=None):
        num_t = state.mean.shape[0]
        num_d = boxes.shape[0]
        dev = boxes.device
        nan_t = torch.full((num_t,), float("nan"), device=dev)

        # 0. camera-motion compensation: move the position memory
        if shift is not None:
            d4 = torch.cat([shift, shift])
            d7 = torch.cat([shift, shift.new_zeros(STATE_DIM - 2)])
            state = state._replace(
                mean=state.mean + d7[None], obs_mean=state.obs_mean + d7[None],
                last_obs=state.last_obs + d4[None],
                prev_obs=state.prev_obs + d4[None])

        # 1. predict all alive tracks at ts
        dt = torch.clamp(ts - state.last_predict_ts, min=1e-3)
        pmean, pcov = _kf_predict(state.mean, state.cov, dt)
        alive = state.alive
        state = state._replace(
            mean=torch.where(alive[:, None], pmean, state.mean),
            cov=torch.where(alive[:, None, None], pcov, state.cov),
            last_predict_ts=torch.where(alive, ts, state.last_predict_ts))

        # 2. association on IoU of predicted vs detected boxes
        det2trk = associate_fn(iou_matrix(x_to_bbox(state.mean), boxes),
                               state.alive, dvalid, conf,
                               (state, boxes, ts, emb))
        matched_d = det2trk >= 0
        trk2det = _put_rows(
            torch.full((num_t,), -1, dtype=torch.int32, device=dev),
            torch.where(matched_d, det2trk, num_t).long(),
            torch.arange(num_d, dtype=torch.int32, device=dev))
        matched_t = trk2det >= 0

        # 3. measurement update for matched tracks, observation memory
        det_idx = trk2det.clamp(0, num_d - 1).long()
        umean, ucov = update_fn(state, boxes, det_idx, matched_t, ts, conf)
        sel_t = matched_t[:, None]
        sel_c = matched_t[:, None, None]
        state = state._replace(
            mean=torch.where(sel_t, umean, state.mean),
            cov=torch.where(sel_c, ucov, state.cov),
            last_update_ts=torch.where(matched_t, ts, state.last_update_ts),
            hits=state.hits + matched_t.to(torch.int32),
            hit_streak=torch.where(
                matched_t, state.hit_streak + 1,
                torch.where(state.alive, torch.zeros_like(state.hit_streak),
                            state.hit_streak)),
            cls_id=torch.where(matched_t, cls_id[det_idx], state.cls_id),
            conf=torch.where(matched_t, conf[det_idx], state.conf),
            prev_obs=torch.where(sel_t, state.last_obs, state.prev_obs),
            prev_obs_ts=torch.where(matched_t, state.last_obs_ts,
                                    state.prev_obs_ts),
            last_obs=torch.where(sel_t, boxes[det_idx], state.last_obs),
            last_obs_ts=torch.where(matched_t, ts, state.last_obs_ts),
            obs_mean=torch.where(sel_t, umean, state.obs_mean),
            obs_cov=torch.where(sel_c, ucov, state.obs_cov))
        if emb is not None:
            # appearance EMA on matched tracks, renormalised; an empty
            # memory adopts the detection's descriptor
            mixed = APP_EMA * state.app + (1.0 - APP_EMA) * emb[det_idx]
            empty = (state.app * state.app).sum(dim=-1) < 1e-9
            mixed = torch.where(empty[:, None], emb[det_idx], mixed)
            nrm = torch.sqrt((mixed * mixed).sum(dim=-1, keepdim=True))
            mixed = mixed / torch.clamp(nrm, min=1e-6)
            state = state._replace(app=torch.where(sel_t, mixed, state.app))

        # 4. metrics for matched tracks from the DET box
        if proj is not None:
            h_mat, origin, maxd = proj
            ground, gvalid = project_boxes_device(h_mat, boxes[det_idx])
            ok = matched_t & gvalid
            gdist = torch.minimum(torch.hypot(ground[:, 0] - origin[0],
                                              ground[:, 1] - origin[1]), maxd)
            new_dist = torch.where(ok, gdist,
                                   torch.where(matched_t, nan_t, state.dist))
            state, w_speed = _history_append_and_window(
                state, ok, ts, ground[:, 0], ground[:, 1], window)
            new_speed = torch.where(ok, w_speed,
                                    torch.where(matched_t, nan_t,
                                                state.speed))
            state = state._replace(dist=new_dist, speed=new_speed)

        # 5. prune stale tracks (before creation: freed slots are reusable)
        state = state._replace(
            alive=state.alive & ((ts - state.last_update_ts) <= staleness))

        # 6. new tracks for the detections new_track_fn picks, ids in
        # det order
        is_new = new_track_fn(dvalid, matched_d, conf)
        rank = torch.cumsum(is_new.to(torch.int32), dim=0) - 1
        new_ids = state.next_id + rank
        free_order = torch.argsort(state.alive.to(torch.int32), stable=True)
        n_free = (~state.alive).sum()
        fits = is_new & (rank < n_free)
        slot = torch.where(fits, free_order[rank.clamp(0, num_t - 1)],
                           num_t).long()
        znew = bbox_to_z(boxes)
        init_mean = torch.cat([znew, torch.zeros((num_d, 3), device=dev)],
                              dim=-1)
        p0 = _p0(dev).expand(num_d, STATE_DIM, STATE_DIM)
        ts_d = ts.expand(num_d)
        state = state._replace(
            mean=_put_rows(state.mean, slot, init_mean),
            cov=_put_rows(state.cov, slot, p0),
            alive=_put_rows(state.alive, slot, True),
            ids=_put_rows(state.ids, slot, new_ids.to(torch.int32)),
            last_predict_ts=_put_rows(state.last_predict_ts, slot, ts_d),
            last_update_ts=_put_rows(state.last_update_ts, slot, ts_d),
            hits=_put_rows(state.hits, slot, 1),
            hit_streak=_put_rows(state.hit_streak, slot, 1),
            cls_id=_put_rows(state.cls_id, slot, cls_id.to(torch.int32)),
            conf=_put_rows(state.conf, slot, conf),
            dist=_put_rows(state.dist, slot, float("nan")),
            speed=_put_rows(state.speed, slot, float("nan")),
            hist_head=_put_rows(state.hist_head, slot, 0),
            hist_len=_put_rows(state.hist_len, slot, 0),
            next_id=state.next_id + is_new.sum().to(torch.int32),
            # first observation: prev == last (no velocity yet)
            last_obs=_put_rows(state.last_obs, slot, boxes),
            last_obs_ts=_put_rows(state.last_obs_ts, slot, ts_d),
            prev_obs=_put_rows(state.prev_obs, slot, boxes),
            prev_obs_ts=_put_rows(state.prev_obs_ts, slot, ts_d),
            obs_mean=_put_rows(state.obs_mean, slot, init_mean),
            obs_cov=_put_rows(state.obs_cov, slot, p0),
            app=(_put_rows(state.app, slot, emb) if emb is not None
                 else state.app))

        # metrics for brand-new tracks (first history entry, speed None)
        if proj is not None:
            h_mat, origin, maxd = proj
            ground_d, gvalid_d = project_boxes_device(h_mat, boxes)
            created_t = _put_rows(
                torch.zeros((num_t,), dtype=torch.bool, device=dev),
                slot, fits)
            src_det = _put_rows(
                torch.zeros((num_t,), dtype=torch.long, device=dev), slot,
                torch.arange(num_d, device=dev))
            okc = created_t & gvalid_d[src_det]
            gdist_t = torch.minimum(
                torch.hypot(ground_d[src_det, 0] - origin[0],
                            ground_d[src_det, 1] - origin[1]), maxd)
            state = state._replace(dist=torch.where(
                okc, gdist_t, torch.where(created_t, nan_t, state.dist)))
            state, _ = _history_append_and_window(
                state, okc, ts, ground_d[src_det, 0], ground_d[src_det, 1],
                window)

        # 7. per-detection outputs
        trk_of_d = det2trk.clamp(0, num_t - 1).long()
        out_id = torch.where(matched_d, state.ids[trk_of_d],
                             torch.where(is_new, new_ids.to(torch.int32),
                                         torch.zeros_like(new_ids,
                                                          dtype=torch.int32)))
        nan_d = torch.full((num_d,), float("nan"), device=dev)
        if proj is not None:
            slot_of_new = slot.clamp(0, num_t - 1)
            out_dist = torch.where(
                matched_d, state.dist[trk_of_d],
                torch.where(fits, state.dist[slot_of_new], nan_d))
            out_spd = torch.where(
                matched_d, state.speed[trk_of_d],
                torch.where(fits, state.speed[slot_of_new], nan_d))
        else:
            out_dist = out_spd = nan_d
        out = SortOutput(
            track_id=torch.where(dvalid, out_id,
                                 torch.zeros_like(out_id)).to(torch.int32),
            distance_m=torch.where(dvalid, out_dist, nan_d),
            speed_kmh=torch.where(dvalid, out_spd * 3.6, nan_d))
        return state, out

    return step


def state_from_jax(arrays: Mapping[str, np.ndarray],
                   device=None) -> SortState:
    """A :class:`SortState` from the JAX package's: ``arrays`` maps its
    field names to numpy arrays (``SortState._asdict()`` through
    ``np.asarray``, or a ``save_state`` file's arrays without the
    ``sort_`` prefix). All 25 fields are read, with the dtypes
    :func:`init_state` uses; a missing one is a ``ValueError`` naming
    it."""
    device = resolve_device(device)
    ref = init_state(1, "cpu")
    missing = [k for k in SortState._fields if k not in arrays]
    if missing:
        raise ValueError(f"state_from_jax: missing fields {missing}")
    return SortState(*[
        torch.from_numpy(np.array(arrays[k])).to(getattr(ref, k).dtype)
        .to(device) for k in SortState._fields])


_check_emb_dim()
