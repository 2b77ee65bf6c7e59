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

JAX runs the association rounds as a device ``while_loop``. Here
:func:`greedy_associate` and :func:`auction_associate` launch a CUDA
kernel for a tensor on the card (K4 ``assoc_greedy``, K5
``assoc_auction``, ``csrc/assoc.cu``: the whole loop in one thread block
a problem, no host read) and run their plain versions for a tensor on
the CPU: those read one flag back to the host per greedy round, and one
per block of :data:`AUCTION_BLOCK` ε-auction rounds. Every such read adds
one to :data:`host_syncs` so a caller can count them per batch. The
default step calls K4 or K5 in its boxes mode
(:func:`greedy_associate_boxes`, :func:`auction_associate_boxes`): one
launch computes what sort_tpu.py:498-508 computes (``x_to_bbox`` of the
predicted means, ``iou_matrix`` against the detections, the rounds, the
inverse map track → det) in the arithmetic of :func:`x_to_bbox` and
:func:`iou_matrix`; its plain version is exactly that composition. The
hooked backends hand K4 (matrix mode) a score matrix of their own.

Every step, hooked or not, also takes a stacked state, every field with
a leading stream axis S, and detections (S, D, ...): JAX's ``vmap`` over
streams written out as a batch dimension, one association launch (a
stage) for all S streams; the hooks see the stream axis too.
:func:`make_sort_scan` runs a step over a sequence of frames (JAX's
``lax.scan``), :func:`scan_steps` any backend's.
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

import ctypes
from typing import Mapping, NamedTuple

import numpy as np
import torch

from ..kernels import _build
from ..utils.device import device_constant, resolve_device

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
    return torch.diag(device_constant(_P0_DIAG, torch.float32, device))


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
    """Pairwise IoU (..., Ta, 4) × (..., Db, 4) → (..., Ta, Db);
    degenerate → 0."""
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
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


def greedy_associate_plain(iou: torch.Tensor, alive: torch.Tensor,
                           dvalid: torch.Tensor, thresh: float
                           ) -> torch.Tensor:
    """Greedy global-argmax matching → det→track (..., D) int32, -1
    unmatched, by mutual-maximum rounds (sort_tpu.py:186-230), over any
    leading problem axes of ``iou`` (..., T, D), ``alive`` (..., T) and
    ``dvalid`` (..., D). One host read per round; a round in which one
    problem has no mutual pair changes nothing in it, so the problems
    come out as one at a time."""
    num_t, num_d = iou.shape[-2:]
    dev = iou.device
    lead = iou.shape[:-2]
    mat = torch.where(alive[..., :, None] & dvalid[..., None, :], iou,
                      torch.full_like(iou, -1.0))
    t_ids = torch.arange(num_t, dtype=torch.int32, device=dev)
    det2trk = torch.full(lead + (num_d,), -1, dtype=torch.int32, device=dev)
    for _ in range(min(num_t, num_d) + 1):
        rbest = mat.argmax(dim=-1)
        cbest = mat.argmax(dim=-2)
        rval = mat.max(dim=-1).values
        mutual = (torch.gather(cbest, -1, rbest).to(torch.int32) == t_ids) \
            & (rval >= thresh) & (rval > -0.5)
        if not read_flag(mutual.any()):
            break
        t_for_d = torch.full(lead + (num_d,), -1, dtype=torch.int32,
                             device=dev) \
            .scatter_reduce(-1, rbest, torch.where(mutual, t_ids, -1),
                            reduce="amax")
        taken_d = torch.zeros(lead + (num_d,), dtype=torch.int32,
                              device=dev) \
            .scatter_reduce(-1, rbest, mutual.to(torch.int32),
                            reduce="amax") > 0
        det2trk = torch.where(taken_d & (det2trk < 0), t_for_d, det2trk)
        mat = torch.where(mutual[..., :, None] | taken_d[..., None, :],
                          torch.full_like(mat, -1.0), mat)
    return det2trk


def auction_round_plain(w: torch.Tensor, prices: torch.Tensor,
                        assigned: torch.Tensor, bidders: torch.Tensor,
                        eps: float):
    """One round of the parallel ε-auction over the values ``w``
    (..., R, C) of R bidders for C columns: every unassigned bidder of
    ``bidders`` (..., R) bids ``v1 − v2 + ε`` for its best-value column
    (first index on ties, NaN above every number), where ``v2`` is the
    maximum after that column's value is set to −1e9; each column goes to
    its highest bid (first bidder on ties), and a column whose top bid is
    not above −inf (none, −inf or NaN) changes nothing. → (prices,
    assigned, best_c, v2, winner, has_bid) after the round."""
    num_c = w.shape[-1]
    col_ids = torch.arange(num_c, device=w.device)
    bid_ids = torch.arange(w.shape[-2], device=w.device)
    values = w - prices[..., None, :]
    best_c = values.argmax(dim=-1)
    v1 = values.max(dim=-1).values
    rest = values.scatter(-1, best_c[..., None], -1e9)
    v2 = rest.max(dim=-1).values
    bidding = (assigned < 0) & bidders
    incr = v1 - v2 + eps
    bid_mat = torch.where(
        bidding[..., :, None] & (best_c[..., :, None] == col_ids),
        incr[..., :, None], float("-inf"))
    top_bid = bid_mat.max(dim=-2).values
    winner = bid_mat.argmax(dim=-2)
    has_bid = top_bid > float("-inf")
    prices = torch.where(has_bid, prices + top_bid, prices)
    own_c = assigned.clamp(0, num_c - 1)
    evicted = (assigned >= 0) & torch.gather(has_bid, -1, own_c) \
        & (torch.gather(winner, -1, own_c) != bid_ids)
    assigned = torch.where(evicted, -1, assigned)
    won = bidding & torch.gather(has_bid, -1, best_c) \
        & (torch.gather(winner, -1, best_c) == bid_ids)
    assigned = torch.where(won, best_c, assigned)
    return prices, assigned, best_c, v2, winner, has_bid


def auction_values_plain(iou: torch.Tensor, alive: torch.Tensor,
                         dvalid: torch.Tensor) -> torch.Tensor:
    """The association auction's values (..., D, T + D) of the scores
    (..., T, D): a detection's score for an alive track where both are
    valid, else −1e9, then D dummy columns at −1."""
    num_d = iou.shape[-1]
    w_real = torch.where(alive[..., :, None] & dvalid[..., None, :], iou,
                         torch.full_like(iou, -1e9)).transpose(-1, -2)
    return torch.cat([w_real, torch.full(iou.shape[:-2] + (num_d, num_d),
                                         -1.0, dtype=torch.float32,
                                         device=iou.device)], dim=-1)


def auction_associate_plain(iou: torch.Tensor, alive: torch.Tensor,
                            dvalid: torch.Tensor, thresh: float,
                            eps: float = 0.01, max_iters: int = 512
                            ) -> torch.Tensor:
    """Optimal-assignment association (``association: hungarian``) by
    the parallel ε-auction of sort_tpu.py:233-311
    (:func:`auction_round_plain` over detections as bidders); D dummy
    columns at −1 let every detection end assigned; pairs on a dummy
    column or below ``thresh`` are unmatched afterwards. Returns
    det→track (..., D) int32, -1 unmatched, over any leading problem
    axes, as :func:`greedy_associate_plain`.

    JAX runs the rounds as a device ``while_loop`` that stops when no
    valid detection is unassigned or after ``max_iters`` rounds. Here
    the rounds run in blocks of :data:`AUCTION_BLOCK` with one read of
    that flag per block. This is exact: once every valid detection is
    assigned, nobody bids, so a further round changes neither prices nor
    assignments (``has_bid`` is false everywhere, hence no eviction and
    no win); and ``max_iters`` is cut at the same round count, the last
    block shortened if needed."""
    num_t, num_d = iou.shape[-2:]
    dev = iou.device
    lead = iou.shape[:-2]
    w = auction_values_plain(iou, alive, dvalid)
    prices = torch.zeros(lead + (num_t + num_d,), dtype=torch.float32,
                         device=dev)
    assigned = torch.full(lead + (num_d,), -1, dtype=torch.int64, device=dev)

    it = 0
    while it < max_iters and read_flag((dvalid & (assigned < 0)).any()):
        for _ in range(min(AUCTION_BLOCK, max_iters - it)):
            prices, assigned = auction_round_plain(w, prices, assigned,
                                                   dvalid, eps)[:2]
        it += AUCTION_BLOCK

    real = (assigned >= 0) & (assigned < num_t)
    trk = assigned.clamp(0, num_t - 1)
    good = real & (torch.gather(iou.transpose(-1, -2), -1,
                                trk[..., None])[..., 0] >= thresh) \
        & torch.gather(alive, -1, trk) & dvalid
    return torch.where(good, trk, -1).to(torch.int32)


# the kernels' shared memory a block may use on the card (227 KB)
SMEM_LIMIT = 232448


def _assoc_operands(iou, alive, dvalid, what: str):
    """Shape and device checks of K4 / K5 → (scores (P, T, D) f32, alive
    (P, T) u8, dvalid (P, D) u8, leading shape) on one card."""
    if iou.dim() < 2 or iou.dtype != torch.float32:
        raise ValueError(f"{what}: expected (..., T, D) float32 scores, "
                         f"got {tuple(iou.shape)} {iou.dtype}")
    num_t, num_d = iou.shape[-2:]
    lead = iou.shape[:-2]
    if num_t < 1 or num_d < 1:
        raise ValueError(f"{what}: empty problem {tuple(iou.shape)}")
    if alive.device != iou.device or dvalid.device != iou.device:
        raise ValueError(f"{what}: scores and masks must be on one device")
    p = int(np.prod(lead, dtype=np.int64)) if lead else 1
    if p < 1 or p > 2 ** 31 - 1:
        raise ValueError(f"{what}: {p} problems in one launch")
    flat = iou.reshape(p, num_t, num_d).contiguous()
    al = alive.to(torch.bool).expand(lead + (num_t,)).reshape(p, num_t) \
        .contiguous().view(torch.uint8)
    dv = dvalid.to(torch.bool).expand(lead + (num_d,)).reshape(p, num_d) \
        .contiguous().view(torch.uint8)
    return flat, al, dv, lead


def greedy_smem_bytes(num_t: int, num_d: int, boxes: bool = False) -> int:
    """The shared memory K4 needs for one (T, D) problem (csrc/assoc.cu):
    the boxes (boxes mode), the maxima, maps and bitsets. The kernel adds
    a cache of the (T, D | 1) cells where it fits in the rest."""
    return 4 * (5 * (num_t + num_d) * boxes + 3 * num_t + 2 * num_d
                + -(-num_t // 32) + -(-num_d // 32))


def _check_smem(num_t: int, num_d: int, boxes: bool, what: str) -> None:
    need = greedy_smem_bytes(num_t, num_d, boxes)
    if need > SMEM_LIMIT:
        raise ValueError(f"{what}: a {num_t} x {num_d} problem needs {need} "
                         f"bytes of shared memory, over one block's "
                         f"{SMEM_LIMIT}")


def _greedy_cuda(iou, alive, dvalid, thresh: float) -> torch.Tensor:
    flat, al, dv, lead = _assoc_operands(iou, alive, dvalid,
                                         "greedy_associate")
    p, num_t, num_d = flat.shape
    _check_smem(num_t, num_d, False, "greedy_associate")
    out = torch.empty((p, num_d), dtype=torch.int32, device=iou.device)
    lib = _build.load("assoc")
    with torch.cuda.device(iou.device):
        code = lib.rvt_assoc_greedy(
            flat.data_ptr(), al.data_ptr(), dv.data_ptr(), out.data_ptr(),
            p, num_t, num_d, ctypes.c_float(float(thresh)),
            _build.stream_ptr(iou))
    _build.launch_counts["assoc_greedy"] += 1
    _build.check(code, "assoc_greedy")
    return out.reshape(lead + (num_d,))


# K5's modes (csrc/assoc.cu)
AUCTION_MATRIX, AUCTION_BOXES, AUCTION_MATCHER = 0, 1, 2


def auction_workspace(lib, mode: int, num_t: int, num_r: int, num_p: int,
                      device):
    """The device-memory workspace K5 needs for ``num_p`` problems of
    ``num_t`` bidder-dependent columns and ``num_r`` bidders, where its
    state outgrows a block's shared memory (some 2,000 tracks and
    detections); None where it fits."""
    per = int(lib.rvt_auction_workspace(mode, num_t, num_r))
    if per == 0:
        return None
    return torch.empty(num_p * per, dtype=torch.uint8, device=device)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _auction_cuda(iou, alive, dvalid, thresh: float, eps: float,
                  max_iters: int) -> torch.Tensor:
    flat, al, dv, lead = _assoc_operands(iou, alive, dvalid,
                                         "auction_associate")
    p, num_t, num_d = flat.shape
    out = torch.empty((p, num_d), dtype=torch.int32, device=iou.device)
    lib = _build.load("assoc")
    ws = auction_workspace(lib, AUCTION_MATRIX, num_t, num_d, p, iou.device)
    with torch.cuda.device(iou.device):
        code = lib.rvt_assoc_auction(
            flat.data_ptr(), al.data_ptr(), dv.data_ptr(), out.data_ptr(),
            _ptr(ws), p, num_t, num_d, ctypes.c_float(float(thresh)),
            ctypes.c_float(float(eps)), int(max_iters),
            _build.stream_ptr(iou))
    _build.launch_counts["assoc_auction"] += 1
    _build.check(code, "assoc_auction")
    return out.reshape(lead + (num_d,))


def greedy_associate(iou: torch.Tensor, alive: torch.Tensor,
                     dvalid: torch.Tensor, thresh: float) -> torch.Tensor:
    """K4 wrapper: det→track (..., D) int32, -1 unmatched, for scores
    (..., T, D), ``alive`` (..., T), ``dvalid`` (..., D). A CPU tensor
    runs :func:`greedy_associate_plain`; a CUDA tensor launches the
    kernel, one block per problem, on the current stream."""
    if iou.device.type == "cpu":
        return greedy_associate_plain(iou, alive, dvalid, thresh)
    if iou.device.type != "cuda":
        raise ValueError(f"unsupported device {iou.device}")
    return _greedy_cuda(iou, alive, dvalid, thresh)


def trk2det_map(det2trk: torch.Tensor, num_t: int) -> torch.Tensor:
    """The inverse of a one-to-one det→track map (P, D) → track→det (P, T)
    int32, -1 unmatched: sort_tpu.py:503-506's scatter with the unmatched
    detections dropped."""
    num_p, num_d = det2trk.shape
    d_ids = torch.arange(num_d, dtype=torch.int32, device=det2trk.device) \
        .expand(num_p, num_d)
    return _put_rows(
        torch.full((num_p, num_t), -1, dtype=torch.int32,
                   device=det2trk.device),
        torch.where(det2trk >= 0, det2trk, num_t).long(), d_ids)


def greedy_associate_boxes_plain(mean: torch.Tensor, boxes: torch.Tensor,
                                 alive: torch.Tensor, dvalid: torch.Tensor,
                                 thresh: float):
    """What sort_tpu.py:498-508 computes: the IoU of the predicted boxes
    ``x_to_bbox(mean)`` (P, T, 7) against ``boxes`` (P, D, 4), greedy
    association, and the inverse map → (det→track (P, D), track→det
    (P, T)) int32, -1 unmatched."""
    det2trk = greedy_associate_plain(iou_matrix(x_to_bbox(mean), boxes),
                                     alive, dvalid, thresh)
    return det2trk, trk2det_map(det2trk, mean.shape[1])


def _check_boxes_shapes(mean, boxes, alive, dvalid, what: str) -> None:
    if mean.dim() != 3 or mean.shape[-1] != STATE_DIM or boxes.dim() != 3 \
            or boxes.shape[-1] != MEAS_DIM or boxes.shape[0] != mean.shape[0] \
            or alive.shape != mean.shape[:2] \
            or dvalid.shape != boxes.shape[:2]:
        raise ValueError(f"{what}: expected mean (P, T, 7), boxes (P, D, 4), "
                         f"alive (P, T), dvalid (P, D), got "
                         f"{tuple(mean.shape)}, {tuple(boxes.shape)}, "
                         f"{tuple(alive.shape)}, {tuple(dvalid.shape)}")


def _boxes_operands(mean, boxes, alive, dvalid, what: str):
    """Device and type checks of a boxes mode on the card → (mean, boxes
    contiguous f32, alive, dvalid u8)."""
    if mean.device.type != "cuda" or any(
            t.device != mean.device for t in (boxes, alive, dvalid)):
        raise ValueError(f"{what}: unsupported devices {mean.device}, "
                         f"{boxes.device}, {alive.device}, {dvalid.device}")
    if mean.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32 means and boxes, got "
                         f"{mean.dtype}, {boxes.dtype}")
    num_p, num_t, num_d = mean.shape[0], mean.shape[1], boxes.shape[1]
    if num_p < 1 or num_t < 1 or num_d < 1 or num_p > 2 ** 31 - 1:
        raise ValueError(f"{what}: empty or too many problems ({num_p}, "
                         f"{num_t}, {num_d})")
    return (mean.contiguous(), boxes.contiguous(),
            alive.to(torch.bool).contiguous().view(torch.uint8),
            dvalid.to(torch.bool).contiguous().view(torch.uint8))


def _greedy_boxes_cuda(mean, boxes, alive, dvalid, thresh: float):
    m, b, al, dv = _boxes_operands(mean, boxes, alive, dvalid,
                                   "greedy_associate_boxes")
    num_p, num_t, num_d = mean.shape[0], mean.shape[1], boxes.shape[1]
    _check_smem(num_t, num_d, True, "greedy_associate_boxes")
    dev = mean.device
    det2trk = torch.empty((num_p, num_d), dtype=torch.int32, device=dev)
    trk2det = torch.empty((num_p, num_t), dtype=torch.int32, device=dev)
    lib = _build.load("assoc")
    with torch.cuda.device(dev):
        code = lib.rvt_assoc_greedy_boxes(
            m.data_ptr(), b.data_ptr(), al.data_ptr(), dv.data_ptr(),
            det2trk.data_ptr(), trk2det.data_ptr(), num_p, num_t, num_d,
            ctypes.c_float(float(thresh)), _build.stream_ptr(mean))
    _build.launch_counts["assoc_greedy"] += 1
    _build.check(code, "assoc_greedy")
    return det2trk, trk2det


def greedy_associate_boxes(mean: torch.Tensor, boxes: torch.Tensor,
                           alive: torch.Tensor, dvalid: torch.Tensor,
                           thresh: float):
    """K4 in boxes mode: (det→track (P, D), track→det (P, T)) int32 for
    predicted means ``mean`` (P, T, 7) f32, detections ``boxes`` (P, D, 4)
    f32, ``alive`` (P, T) and ``dvalid`` (P, D). A CPU tensor runs
    :func:`greedy_associate_boxes_plain`; a CUDA tensor launches the
    kernel, IoU included, one block per problem, on the current stream."""
    _check_boxes_shapes(mean, boxes, alive, dvalid, "greedy_associate_boxes")
    if mean.device.type == "cpu":
        return greedy_associate_boxes_plain(mean, boxes, alive, dvalid,
                                            thresh)
    return _greedy_boxes_cuda(mean, boxes, alive, dvalid, thresh)


def auction_associate(iou: torch.Tensor, alive: torch.Tensor,
                      dvalid: torch.Tensor, thresh: float,
                      eps: float = 0.01, max_iters: int = 512
                      ) -> torch.Tensor:
    """K5 wrapper, as :func:`greedy_associate`, for
    :func:`auction_associate_plain`."""
    if iou.device.type == "cpu":
        return auction_associate_plain(iou, alive, dvalid, thresh, eps,
                                       max_iters)
    if iou.device.type != "cuda":
        raise ValueError(f"unsupported device {iou.device}")
    return _auction_cuda(iou, alive, dvalid, thresh, eps, max_iters)


def auction_associate_boxes_plain(mean: torch.Tensor, boxes: torch.Tensor,
                                  alive: torch.Tensor, dvalid: torch.Tensor,
                                  thresh: float, eps: float = 0.01,
                                  max_iters: int = 512):
    """:func:`greedy_associate_boxes_plain` with the ε-auction: the IoU of
    ``x_to_bbox(mean)`` (P, T, 7) against ``boxes`` (P, D, 4),
    :func:`auction_associate_plain` and the inverse map → (det→track
    (P, D), track→det (P, T)) int32, -1 unmatched."""
    det2trk = auction_associate_plain(iou_matrix(x_to_bbox(mean), boxes),
                                      alive, dvalid, thresh, eps, max_iters)
    return det2trk, trk2det_map(det2trk, mean.shape[1])


def _auction_boxes_cuda(mean, boxes, alive, dvalid, thresh: float,
                        eps: float, max_iters: int):
    m, b, al, dv = _boxes_operands(mean, boxes, alive, dvalid,
                                   "auction_associate_boxes")
    num_p, num_t, num_d = mean.shape[0], mean.shape[1], boxes.shape[1]
    dev = mean.device
    det2trk = torch.empty((num_p, num_d), dtype=torch.int32, device=dev)
    trk2det = torch.empty((num_p, num_t), dtype=torch.int32, device=dev)
    lib = _build.load("assoc")
    ws = auction_workspace(lib, AUCTION_BOXES, num_t, num_d, num_p, dev)
    with torch.cuda.device(dev):
        code = lib.rvt_assoc_auction_boxes(
            m.data_ptr(), b.data_ptr(), al.data_ptr(), dv.data_ptr(),
            det2trk.data_ptr(), trk2det.data_ptr(), _ptr(ws), num_p, num_t,
            num_d, ctypes.c_float(float(thresh)), ctypes.c_float(float(eps)),
            int(max_iters), _build.stream_ptr(mean))
    _build.launch_counts["assoc_auction"] += 1
    _build.check(code, "assoc_auction")
    return det2trk, trk2det


def auction_associate_boxes(mean: torch.Tensor, boxes: torch.Tensor,
                            alive: torch.Tensor, dvalid: torch.Tensor,
                            thresh: float, eps: float = 0.01,
                            max_iters: int = 512):
    """K5 in boxes mode, as :func:`greedy_associate_boxes` (the default
    step's association for ``association: hungarian``): a CPU tensor runs
    :func:`auction_associate_boxes_plain`; a CUDA tensor launches the
    kernel, IoU and inverse map included, one block per problem."""
    _check_boxes_shapes(mean, boxes, alive, dvalid, "auction_associate_boxes")
    if mean.device.type == "cpu":
        return auction_associate_boxes_plain(mean, boxes, alive, dvalid,
                                             thresh, eps, max_iters)
    return _auction_boxes_cuda(mean, boxes, alive, dvalid, thresh, eps,
                               max_iters)


def _kf_predict(mean, cov, dt):
    """Kalman predict of every row of ``mean`` (..., 7) and ``cov``
    (..., 7, 7) over ``dt`` (...)."""
    lead = mean.shape[:-1]
    mean = mean.reshape(-1, STATE_DIM)
    cov = cov.reshape(-1, STATE_DIM, STATE_DIM)
    dt = dt.reshape(-1)
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
    return new_mean.reshape(lead + (STATE_DIM,)), \
        new_cov.reshape(lead + (STATE_DIM, STATE_DIM))


def nsa_r_scale(conf: torch.Tensor) -> torch.Tensor:
    """NSA measurement-noise scale (1 − conf), floored at 1e-3 so that R
    stays positive definite at conf → 1."""
    return torch.clamp(1.0 - conf, min=1e-3)


def _kf_update(mean, cov, z, r_scale=None):
    """Batched KF update of every row of ``mean`` (..., 7), H = [I4 0],
    Joseph-form covariance (filterpy). ``r_scale`` (...) scales the
    measurement noise per track (NSA). ``solve_ex`` reads no error flag
    back to the host (``solve`` would), so the update runs inside a
    captured CUDA graph; the two give the same values."""
    lead = mean.shape[:-1]
    mean = mean.reshape(-1, STATE_DIM)
    cov = cov.reshape(-1, STATE_DIM, STATE_DIM)
    z = z.reshape(-1, MEAS_DIM)
    t = mean.shape[0]
    dev = mean.device
    r = torch.diag(device_constant(_R_DIAG, torch.float32, dev))
    if r_scale is None:
        r = r.expand(t, MEAS_DIM, MEAS_DIM)
    else:
        r = r_scale.reshape(-1)[:, None, None] * r[None]
    ph = cov[:, :, :MEAS_DIM]
    s = cov[:, :MEAS_DIM, :MEAS_DIM] + r
    k = torch.linalg.solve_ex(s, ph.transpose(1, 2)).result.transpose(1, 2)
    innov = z - mean[:, :MEAS_DIM]
    new_mean = mean + torch.einsum("tij,tj->ti", k, innov)
    kh = torch.zeros_like(cov)
    kh[:, :, :MEAS_DIM] = k
    i_kh = torch.eye(STATE_DIM, device=dev)[None] - kh
    new_cov = torch.einsum("tij,tjk,tlk->til", i_kh, cov, i_kh) \
        + torch.einsum("tij,tjk,tlk->til", k, r, k)
    return new_mean.reshape(lead + (STATE_DIM,)), \
        new_cov.reshape(lead + (STATE_DIM, STATE_DIM))


def _at(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``buf[..., idx]`` element by element: (..., N) at (...) → (...)."""
    return torch.gather(buf, -1, idx[..., None])[..., 0]


def _history_append_and_window(state: SortState, sel, ts, gx, gy, window):
    """Append the ground points of the ``sel`` tracks (..., T) at ``ts``
    (...) to their history rings, drop entries older than ``window``
    seconds and give the windowed speed (..., T)."""
    dev = sel.device
    head, length = state.hist_head, state.hist_len
    full = length >= HISTORY
    write_pos = ((head + length) % HISTORY).long()[..., None]
    head_after = torch.where(sel & full, (head + 1) % HISTORY, head)
    len_after = torch.where(sel & ~full, length + 1, length)

    def put(buf, val):
        cur = torch.gather(buf, -1, write_pos)[..., 0]
        return buf.scatter(-1, write_pos, torch.where(sel, val, cur)[..., None])

    hist_ts = put(state.hist_ts, ts[..., None].expand(sel.shape))
    hist_x = put(state.hist_x, gx)
    hist_y = put(state.hist_y, gy)

    slot = torch.arange(HISTORY, device=dev)
    order = (slot - head_after[..., None]) % HISTORY
    in_buf = order < len_after[..., None]
    expired = in_buf & ((ts[..., None, None] - hist_ts) > window)
    n_exp = expired.sum(dim=-1).to(torch.int32)
    head_new = torch.where(sel, (head_after + n_exp) % HISTORY, head_after)
    len_new = torch.where(sel, len_after - n_exp, len_after)

    first = head_new.long()
    last = ((head_new + torch.clamp(len_new - 1, min=0)) % HISTORY).long()
    t0 = _at(hist_ts, first)
    t1 = _at(hist_ts, last)
    dx = _at(hist_x, last) - _at(hist_x, first)
    dy = _at(hist_y, last) - _at(hist_y, first)
    spd = torch.hypot(dx, dy) / torch.clamp(t1 - t0, min=1e-3)
    speed = torch.where(len_new >= 2, spd, torch.full_like(spd, float("nan")))
    return state._replace(hist_ts=hist_ts, hist_x=hist_x, hist_y=hist_y,
                          hist_head=head_new.to(torch.int32),
                          hist_len=len_new.to(torch.int32)), speed


def _put_rows(buf: torch.Tensor, index: torch.Tensor, values) -> torch.Tensor:
    """``buf.at[s, index].set(values, mode="drop")`` for every stream s
    of ``buf`` (S, T, ...), ``index`` (S, N) in [0, T]: row T of each
    stream is a scratch row that takes the dropped writes, then goes
    away. A number is written as a fill on the device (a capture cannot
    copy it from the host)."""
    ext = torch.cat([buf, buf[:, :1]], dim=1)
    streams = torch.arange(buf.shape[0], device=buf.device)[:, None] \
        .expand_as(index)
    ext[streams, index] = values if torch.is_tensor(values) \
        else buf.new_full((), values)
    return ext[:, :-1]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (..., M) of ``x`` (..., N, F...) → (..., M, F...),
    the leading axes of ``idx`` those of ``x`` (a stream axis, or none)."""
    lead = idx.dim()
    shape = idx.shape + (1,) * (x.dim() - lead)
    return torch.gather(x, lead - 1, idx.reshape(shape).expand(
        idx.shape + x.shape[lead:]))


def _squeeze_state(state: SortState) -> SortState:
    return SortState(*[t[0] for t in state])


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

    The step also takes a stacked state (every field with a leading
    stream axis S, ``init_multi_state``) with detections (S, D, ...),
    ``ts`` (S,), ``emb`` (S, D, E) and ``shift`` (S, 2): each stream as
    its own step would run it, one association launch (a stage) for all
    S.

    ``association``: "greedy" (the reference,
    :func:`greedy_associate_boxes`) or "hungarian" (the ε-auction,
    :func:`auction_associate_boxes`). The hooks, as in JAX, with the
    stream axis leading every argument (S = 1 for a single stream):
    ``associate_fn(iou (S,T,D), alive (S,T), dvalid (S,D), conf (S,D),
    ctx) → det→track (S,D)`` with ``ctx = (state, boxes (S,D,4), ts
    (S,), emb (S,D,E) | None)`` after the predict (replaces the
    association); ``new_track_fn(dvalid, matched_d, conf) → (S,D)`` bool
    (who starts a track); ``update_fn(state, boxes, det_idx (S,T),
    matched_t (S,T), ts, conf) → (mean, cov)`` (the measurement update;
    rows of unmatched tracks are ignored). Hooks written over ``...``
    leading axes serve both. ``nsa`` turns on the confidence-scaled
    measurement noise of the default update."""
    thresh = float(iou_threshold)
    staleness = float(max_staleness)
    window = max(0.05, float(speed_window))
    del min_hits   # tracked by the reference but never gates output
    use_nsa = bool(nsa)
    assoc = associate_fn
    if associate_fn is None:
        if association not in ("greedy", "hungarian"):
            raise ValueError(f"unknown association: {association!r} "
                             f"(expected 'greedy' or 'hungarian')")
        # the default step: K4 (greedy) or K5 (hungarian) computes the IoU
        # and the inverse map too (boxes mode)
        assoc_boxes = greedy_associate_boxes if association == "greedy" \
            else auction_associate_boxes
    else:
        assoc_boxes = None
    new_tracks = new_track_fn
    if new_track_fn is None:
        def new_tracks(dvalid, matched_d, conf):
            return dvalid & ~matched_d
    update = update_fn
    if update_fn is None:
        def update(state, boxes, det_idx, matched_t, ts, conf):
            return _kf_update(state.mean, state.cov,
                              _take(bbox_to_z(boxes), det_idx),
                              nsa_r_scale(torch.gather(conf, 1, det_idx))
                              if use_nsa else None)

    from ..geometry.projector import project_boxes_device

    def stacked(state: SortState, boxes, cls_id, conf, dvalid, ts, proj,
                emb, shift):
        num_s, num_t = state.mean.shape[:2]
        num_d = boxes.shape[1]
        dev = boxes.device
        nan_t = torch.full((num_s, num_t), float("nan"), device=dev)
        ts_t = ts[:, None]

        # 0. camera-motion compensation: move the position memory
        if shift is not None:
            d4 = torch.cat([shift, shift], dim=-1)[:, None]
            d7 = torch.cat([shift, shift.new_zeros((num_s,
                                                    STATE_DIM - 2))],
                           dim=-1)[:, None]
            state = state._replace(
                mean=state.mean + d7, obs_mean=state.obs_mean + d7,
                last_obs=state.last_obs + d4, prev_obs=state.prev_obs + d4)

        # 1. predict all alive tracks at ts
        dt = torch.clamp(ts_t - state.last_predict_ts, min=1e-3)
        pmean, pcov = _kf_predict(state.mean, state.cov, dt)
        alive = state.alive
        state = state._replace(
            mean=torch.where(alive[..., None], pmean, state.mean),
            cov=torch.where(alive[..., None, None], pcov, state.cov),
            last_predict_ts=torch.where(alive, ts_t, state.last_predict_ts))

        # 2. association on IoU of predicted vs detected boxes
        if assoc_boxes is not None:
            det2trk, trk2det = assoc_boxes(state.mean, boxes, state.alive,
                                           dvalid, thresh)
        else:
            det2trk = assoc(iou_matrix(x_to_bbox(state.mean), boxes),
                            state.alive, dvalid, conf,
                            (state, boxes, ts, emb))
            trk2det = trk2det_map(det2trk, num_t)
        matched_d = det2trk >= 0
        matched_t = trk2det >= 0
        d_ids = torch.arange(num_d, dtype=torch.int32, device=dev) \
            .expand(num_s, num_d)

        # 3. measurement update for matched tracks, observation memory
        det_idx = trk2det.clamp(0, num_d - 1).long()
        umean, ucov = update(state, boxes, det_idx, matched_t, ts, conf)
        sel_t = matched_t[..., None]
        sel_c = matched_t[..., None, None]
        boxes_t = _take(boxes, det_idx)
        state = state._replace(
            mean=torch.where(sel_t, umean, state.mean),
            cov=torch.where(sel_c, ucov, state.cov),
            last_update_ts=torch.where(matched_t, ts_t, state.last_update_ts),
            hits=state.hits + matched_t.to(torch.int32),
            hit_streak=torch.where(
                matched_t, state.hit_streak + 1,
                torch.where(state.alive, torch.zeros_like(state.hit_streak),
                            state.hit_streak)),
            cls_id=torch.where(matched_t, torch.gather(cls_id, 1, det_idx),
                               state.cls_id),
            conf=torch.where(matched_t, torch.gather(conf, 1, det_idx),
                             state.conf),
            prev_obs=torch.where(sel_t, state.last_obs, state.prev_obs),
            prev_obs_ts=torch.where(matched_t, state.last_obs_ts,
                                    state.prev_obs_ts),
            last_obs=torch.where(sel_t, boxes_t, state.last_obs),
            last_obs_ts=torch.where(matched_t, ts_t, state.last_obs_ts),
            obs_mean=torch.where(sel_t, umean, state.obs_mean),
            obs_cov=torch.where(sel_c, ucov, state.obs_cov))
        if emb is not None:
            # appearance EMA on matched tracks, renormalised; an empty
            # memory adopts the detection's descriptor
            emb_t = _take(emb, det_idx)
            mixed = APP_EMA * state.app + (1.0 - APP_EMA) * emb_t
            empty = (state.app * state.app).sum(dim=-1) < 1e-9
            mixed = torch.where(empty[..., None], emb_t, mixed)
            nrm = torch.sqrt((mixed * mixed).sum(dim=-1, keepdim=True))
            mixed = mixed / torch.clamp(nrm, min=1e-6)
            state = state._replace(app=torch.where(sel_t, mixed, state.app))

        # 4. metrics for matched tracks from the DET box
        if proj is not None:
            h_mat, origin, maxd = proj
            ground, gvalid = project_boxes_device(h_mat, boxes_t)
            ok = matched_t & gvalid
            gdist = torch.minimum(torch.hypot(ground[..., 0] - origin[0],
                                              ground[..., 1] - origin[1]),
                                  maxd)
            new_dist = torch.where(ok, gdist,
                                   torch.where(matched_t, nan_t, state.dist))
            state, w_speed = _history_append_and_window(
                state, ok, ts, ground[..., 0], ground[..., 1], window)
            new_speed = torch.where(ok, w_speed,
                                    torch.where(matched_t, nan_t,
                                                state.speed))
            state = state._replace(dist=new_dist, speed=new_speed)

        # 5. prune stale tracks (before creation: freed slots are reusable)
        state = state._replace(
            alive=state.alive & ((ts_t - state.last_update_ts) <= staleness))

        # 6. new tracks for the detections new_tracks picks, ids in
        # det order
        is_new = new_tracks(dvalid, matched_d, conf)
        rank = torch.cumsum(is_new.to(torch.int32), dim=-1) - 1
        new_ids = state.next_id[:, None] + rank
        free_order = torch.argsort(state.alive.to(torch.int32), dim=-1,
                                   stable=True)
        n_free = (~state.alive).sum(dim=-1)
        fits = is_new & (rank < n_free[:, None])
        slot = torch.where(
            fits, torch.gather(free_order, 1, rank.clamp(0, num_t - 1)),
            num_t).long()
        znew = bbox_to_z(boxes)
        init_mean = torch.cat(
            [znew, torch.zeros((num_s, num_d, 3), device=dev)], dim=-1)
        p0 = _p0(dev).expand(num_s, num_d, STATE_DIM, STATE_DIM)
        ts_d = ts_t.expand(num_s, num_d)
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
            next_id=state.next_id + is_new.sum(dim=-1).to(torch.int32),
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
                torch.zeros((num_s, num_t), dtype=torch.bool, device=dev),
                slot, fits)
            src_det = _put_rows(
                torch.zeros((num_s, num_t), dtype=torch.long, device=dev),
                slot, d_ids.long())
            okc = created_t & torch.gather(gvalid_d, 1, src_det)
            ground_t = _take(ground_d, src_det)
            gdist_t = torch.minimum(
                torch.hypot(ground_t[..., 0] - origin[0],
                            ground_t[..., 1] - origin[1]), maxd)
            state = state._replace(dist=torch.where(
                okc, gdist_t, torch.where(created_t, nan_t, state.dist)))
            state, _ = _history_append_and_window(
                state, okc, ts, ground_t[..., 0], ground_t[..., 1], window)

        # 7. per-detection outputs
        trk_of_d = det2trk.clamp(0, num_t - 1).long()
        out_id = torch.where(matched_d, torch.gather(state.ids, 1, trk_of_d),
                             torch.where(is_new, new_ids.to(torch.int32),
                                         torch.zeros_like(new_ids,
                                                          dtype=torch.int32)))
        nan_d = torch.full((num_s, num_d), float("nan"), device=dev)
        if proj is not None:
            slot_of_new = slot.clamp(0, num_t - 1)
            out_dist = torch.where(
                matched_d, torch.gather(state.dist, 1, trk_of_d),
                torch.where(fits, torch.gather(state.dist, 1, slot_of_new),
                            nan_d))
            out_spd = torch.where(
                matched_d, torch.gather(state.speed, 1, trk_of_d),
                torch.where(fits, torch.gather(state.speed, 1, slot_of_new),
                            nan_d))
        else:
            out_dist = out_spd = nan_d
        out = SortOutput(
            track_id=torch.where(dvalid, out_id,
                                 torch.zeros_like(out_id)).to(torch.int32),
            distance_m=torch.where(dvalid, out_dist, nan_d),
            speed_kmh=torch.where(dvalid, out_spd * 3.6, nan_d))
        return state, out

    def step(state: SortState, boxes, cls_id, conf, dvalid, ts, proj=None,
             emb=None, shift=None):
        if state.mean.dim() == 3:
            if boxes.dim() != 3:
                raise ValueError(f"a stacked state of {state.mean.shape[0]}"
                                 f" streams takes (S, D, 4) detections, "
                                 f"got {tuple(boxes.shape)}")
            return stacked(state, boxes, cls_id, conf, dvalid, ts, proj,
                           emb, shift)
        one = stacked(SortState(*[t[None] for t in state]), boxes[None],
                      cls_id[None], conf[None], dvalid[None], ts.reshape(1),
                      proj, None if emb is None else emb[None],
                      None if shift is None else shift[None])
        return _squeeze_state(one[0]), SortOutput(*[t[0] for t in one[1]])

    return step


def scan_steps(step, state: SortState, boxes, cls_id, conf, dvalid, ts,
               proj=None, emb=None, shift=None):
    """Run a tracker step over a sequence of frames (JAX's ``lax.scan``
    over the batch's time axis): every per-frame argument has its frames
    on axis 0 for one stream's state, on axis 1 (after the stream axis)
    for a stacked state → (state', SortOutput stacked on that axis)."""
    axis = 1 if state.mean.dim() == 3 else 0
    outs = []
    for i in range(boxes.shape[axis]):
        def frame(a):
            return None if a is None else a.select(axis, i)
        state, out = step(state, frame(boxes), frame(cls_id), frame(conf),
                          frame(dvalid), frame(ts), proj, frame(emb),
                          frame(shift))
        outs.append(out)
    return state, SortOutput(*[torch.stack(f, dim=axis) for f in zip(*outs)])


def make_sort_scan(iou_threshold: float, max_staleness: float,
                   speed_window: float, min_hits: int = 3,
                   with_projector: bool = False):
    """``scan(state, boxes (F,D,4), cls (F,D), conf (F,D), valid (F,D),
    ts (F,), proj=None) → (state', SortOutput stacked over F)``, as
    ``sort_tpu.py::make_sort_scan`` (:653); ``proj`` is read only when
    ``with_projector``. A stacked state (S streams) takes (S, F, ...)
    detections and (S, F) stamps and gives (S, F, ...) outputs."""
    step = make_sort_step(iou_threshold, max_staleness, speed_window,
                          min_hits)

    def scan(state: SortState, boxes, cls_id, conf, dvalid, ts, proj=None):
        return scan_steps(step, state, boxes, cls_id, conf, dvalid, ts,
                          proj if with_projector else None)

    return scan


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
