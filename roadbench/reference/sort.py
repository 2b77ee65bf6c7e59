"""SORT (Bewley et al., arXiv:1602.00763) with ground-plane metrics,
plain NumPy float32, every camera's tracker stacked on a leading axis.

The variant the configurations run: a constant-velocity Kalman filter
on z = [cx, cy, s = w·h, r = w/h] (w, h floored at 1e-3;
P0 = diag(10, 10, 10, 10, 1e4, 1e4, 1e4), R = diag(1, 1, 10, 10),
Q = diag(.04dt², .04dt², .04dt², 0, dt, dt, dt), dt ≥ 1e-3 s from the
timestamps, Joseph-form update); association by greedy global maximum
of the IoU between predicted and detected boxes (first flat index on
ties) while it is at least the threshold; every unmatched detection
starts a track and takes the next id at once, in detection order; a
track unmatched for longer than the staleness is dropped before new
tracks take slots; a track that finds no free slot keeps its id but is
not kept. Distance: the detection box's bottom centre through the
homography, its distance to the origin clamped; speed: displacement
between the first and last ground points of the track's last
``speed_window`` seconds (32 at most) over their time, in km/h.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

F32 = np.float32
HISTORY = 32
P0 = np.diag(np.array([10, 10, 10, 10, 1e4, 1e4, 1e4], F32)).astype(F32)
R = np.diag(np.array([1, 1, 10, 10], F32)).astype(F32)


def bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 (to nearest, ties to even), as float32."""
    u = np.asarray(x, F32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return np.where(np.isnan(x), x, r.view(F32)).astype(F32)


def homography(image_points, world_points) -> np.ndarray:
    """The 3 × 3 map from image to ground points (float64, H[2,2] = 1),
    by the normalised direct linear transform."""
    src = np.asarray(image_points, F32).astype(np.float64)
    dst = np.asarray(world_points, F32).astype(np.float64)

    def norm(pts):
        mean = pts.mean(axis=0)
        s = np.sqrt(2.0) / np.mean(np.linalg.norm(pts - mean, axis=1))
        return (pts - mean) * s, np.array([[s, 0, -s * mean[0]],
                                           [0, s, -s * mean[1]], [0, 0, 1]])

    sn, ts = norm(src)
    dn, td = norm(dst)
    rows = []
    for (x, y), (u, v) in zip(sn, dn):
        rows.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        rows.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    h = np.linalg.svd(np.asarray(rows))[2][-1].reshape(3, 3)
    h = np.linalg.inv(td) @ h @ ts
    return h / h[2, 2]


def ground(h: np.ndarray, boxes: np.ndarray):
    """Boxes (..., 4) → bottom-centre ground points (..., 2), valid."""
    hm = h.astype(F32)
    x = F32(0.5) * (boxes[..., 0] + boxes[..., 2])
    y = boxes[..., 3]
    u = hm[0, 0] * x + hm[0, 1] * y + hm[0, 2]
    v = hm[1, 0] * x + hm[1, 1] * y + hm[1, 2]
    w = hm[2, 0] * x + hm[2, 1] * y + hm[2, 2]
    small = np.abs(w) < 1e-6
    sw = np.where(small, F32(1), w)
    g = np.stack([u / sw, v / sw], axis=-1)
    ok = ~small & np.isfinite(g).all(axis=-1)
    return np.where(ok[..., None], g, F32(0)), ok


def _bbox_to_z(b: np.ndarray) -> np.ndarray:
    w = np.maximum(b[..., 2] - b[..., 0], F32(1e-3))
    h = np.maximum(b[..., 3] - b[..., 1], F32(1e-3))
    return np.stack([b[..., 0] + F32(0.5) * w, b[..., 1] + F32(0.5) * h,
                     w * h, w / h], axis=-1)


def _x_to_bbox(m: np.ndarray) -> np.ndarray:
    w = np.sqrt(np.maximum(m[..., 2] * m[..., 3], F32(1e-6)))
    h = m[..., 2] / np.maximum(w, F32(1e-6))
    return np.stack([m[..., 0] - F32(0.5) * w, m[..., 1] - F32(0.5) * h,
                     m[..., 0] + F32(0.5) * w, m[..., 1] + F32(0.5) * h],
                    axis=-1)


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(S, T, 4) × (S, D, 4) → (S, T, D)."""
    a, b = a[:, :, None], b[:, None]
    iw = np.maximum(np.minimum(a[..., 2], b[..., 2])
                    - np.maximum(a[..., 0], b[..., 0]), F32(0))
    ih = np.maximum(np.minimum(a[..., 3], b[..., 3])
                    - np.maximum(a[..., 1], b[..., 1]), F32(0))
    inter = iw * ih
    area_a = np.maximum(a[..., 2] - a[..., 0], F32(0)) \
        * np.maximum(a[..., 3] - a[..., 1], F32(0))
    area_b = np.maximum(b[..., 2] - b[..., 0], F32(0)) \
        * np.maximum(b[..., 3] - b[..., 1], F32(0))
    den = area_a + area_b - inter
    return np.where(den > 0, inter / np.where(den > 0, den, F32(1)), F32(0))


def _kf_predict(mean, cov, dt):
    """Every row's Kalman predict over ``dt`` (float32)."""
    f = np.broadcast_to(np.eye(7, dtype=F32), mean.shape + (7,)).copy()
    for i, j in ((0, 4), (1, 5), (2, 6)):
        f[..., i, j] = dt
    q = F32(0.04) * dt * dt
    qd = np.stack([q, q, q, np.zeros_like(dt), dt, dt, dt], axis=-1)
    nm = (f @ mean[..., None])[..., 0]
    nc = f @ cov @ np.swapaxes(f, -1, -2) + qd[..., None] * np.eye(7, dtype=F32)
    return nm.astype(F32), nc.astype(F32)


def _solve(a, b):
    """``np.linalg.solve`` of every row; where a row's matrix is singular
    or not finite (a state rounded to bfloat16 can be), that row's
    answer is NaN, as a batched solve on the card gives, and the others
    are solved alone."""
    try:
        return np.linalg.solve(a, b)
    except np.linalg.LinAlgError:
        with np.errstate(invalid="ignore", over="ignore"):
            det = np.linalg.det(a)
        bad = ~np.isfinite(det) | (det == 0) \
            | ~np.isfinite(a).all(axis=(-2, -1))
        eye = np.broadcast_to(np.eye(a.shape[-1], dtype=a.dtype), a.shape)
        x = np.linalg.solve(np.where(bad[..., None, None], eye, a), b)
        return np.where(bad[..., None, None], np.nan, x).astype(x.dtype)


def _kf_update(mean, cov, z):
    """Every row's Joseph-form update with the measurement ``z``
    (float32)."""
    ph = cov[..., :, :4]
    k = np.swapaxes(_solve(cov[..., :4, :4] + R,
                           np.swapaxes(ph, -1, -2)), -1, -2)
    nm = mean + (k @ (z - mean[..., :4])[..., None])[..., 0]
    kh = np.zeros_like(cov)
    kh[..., :4] = k
    ikh = np.eye(7, dtype=F32) - kh
    nc = ikh @ cov @ np.swapaxes(ikh, -1, -2) \
        + k @ R @ np.swapaxes(k, -1, -2)
    return nm.astype(F32), nc.astype(F32)


class Tracker:
    """S cameras' SORT state; :meth:`step` runs one frame of each. With
    ``low=True`` every value the step keeps or hands on (boxes, the
    filter's state, overlaps, ground points, distances, speeds) is
    rounded to bfloat16: the precision below the configuration's."""

    def __init__(self, cameras: int, slots: int, rules: Dict,
                 geometry: Tuple[np.ndarray, np.ndarray, float],
                 low: bool = False):
        s, t = cameras, slots
        self.rnd = bf16 if low else (lambda x: x)
        self.iou_thres = float(rules["iou_threshold"])
        self.staleness = float(rules["max_staleness"])
        self.window = F32(max(0.05, float(rules["speed_window"])))
        self.h, origin, maxd = geometry
        self.origin = np.asarray(origin, F32)
        self.maxd = F32(maxd)
        self.mean = np.zeros((s, t, 7), F32)
        self.cov = np.broadcast_to(P0, (s, t, 7, 7)).copy()
        self.alive = np.zeros((s, t), bool)
        self.ids = np.zeros((s, t), np.int32)
        self.pred_ts = np.zeros((s, t), F32)
        self.upd_ts = np.zeros((s, t), F32)
        self.dist = np.full((s, t), np.nan, F32)
        self.speed = np.full((s, t), np.nan, F32)
        self.hts = np.zeros((s, t, HISTORY), F32)
        self.hx = np.zeros((s, t, HISTORY), F32)
        self.hy = np.zeros((s, t, HISTORY), F32)
        self.head = np.zeros((s, t), np.int64)
        self.length = np.zeros((s, t), np.int64)
        self.next_id = np.ones(s, np.int64)
        # what the traffic asks of the slots: live tracks after each
        # step, and new tracks that found no free slot
        self.live_max = 0
        self.live_sum = 0
        self.steps = 0
        self.dropped = 0

    def _dist(self, g: np.ndarray) -> np.ndarray:
        d = np.hypot(g[..., 0] - self.origin[0], g[..., 1] - self.origin[1])
        return np.minimum(d.astype(F32), self.maxd)

    def _history(self, sel, ts, gx, gy) -> np.ndarray:
        """Append the ground points of the ``sel`` tracks at ``ts``, drop
        what is older than the window → the windowed speed (m/s)."""
        full = self.length >= HISTORY
        pos = (self.head + self.length) % HISTORY
        head = np.where(sel & full, (self.head + 1) % HISTORY, self.head)
        length = np.where(sel & ~full, self.length + 1, self.length)
        si, ti = np.nonzero(sel)
        p = pos[si, ti]
        self.hts[si, ti, p] = ts[si]
        self.hx[si, ti, p] = gx[si, ti]
        self.hy[si, ti, p] = gy[si, ti]
        order = (np.arange(HISTORY) - head[..., None]) % HISTORY
        expired = (order < length[..., None]) \
            & ((ts[:, None, None] - self.hts) > self.window)
        n_exp = expired.sum(axis=-1)
        self.head = np.where(sel, (head + n_exp) % HISTORY, head)
        self.length = np.where(sel, length - n_exp, length)
        first = self.head
        last = (self.head + np.maximum(self.length - 1, 0)) % HISTORY

        def at(buf, i):
            return np.take_along_axis(buf, i[..., None], axis=-1)[..., 0]

        dt = np.maximum(at(self.hts, last) - at(self.hts, first), F32(1e-3))
        spd = np.hypot(at(self.hx, last) - at(self.hx, first),
                       at(self.hy, last) - at(self.hy, first)).astype(F32) / dt
        return np.where(self.length >= 2, spd, F32(np.nan))

    def step(self, boxes, dvalid, ts):
        """boxes (S, D, 4), dvalid (S, D), ts (S,) float32 → per detection
        (ids (S, D) int32, distance (S, D) m, speed (S, D) km/h)."""
        s, t = self.alive.shape
        d = boxes.shape[1]
        rnd = self.rnd
        boxes = rnd(boxes)
        # 1. predict the alive tracks
        dt = np.maximum(ts[:, None] - self.pred_ts, F32(1e-3))
        pm, pc = _kf_predict(self.mean, self.cov, dt)
        a = self.alive
        self.mean = rnd(np.where(a[..., None], pm, self.mean).astype(F32))
        self.cov = rnd(np.where(a[..., None, None], pc, self.cov).astype(F32))
        self.pred_ts = np.where(a, ts[:, None], self.pred_ts)
        # 2. greedy association, global maximum first
        mat = np.where(a[..., None] & dvalid[:, None],
                       rnd(_iou(_x_to_bbox(self.mean), boxes)), F32(-1))
        mat = mat.reshape(s, t * d)
        det2trk = np.full((s, d), -1, np.int64)
        trk2det = np.full((s, t), -1, np.int64)
        rows = np.arange(s)
        while True:
            best = mat.argmax(axis=1)
            val = mat[rows, best]
            take = (val >= self.iou_thres) & (val > -0.5)
            if not take.any():
                break
            si = rows[take]
            ti, di = best[take] // d, best[take] % d
            det2trk[si, di] = ti
            trk2det[si, ti] = di
            m3 = mat.reshape(s, t, d)
            m3[si, ti, :] = -1
            m3[si, :, di] = -1
        matched_d, matched_t = det2trk >= 0, trk2det >= 0
        # 3. Joseph-form update of the matched tracks
        didx = np.maximum(trk2det, 0)
        bt = np.take_along_axis(boxes, didx[..., None], axis=1)
        z = _bbox_to_z(bt)
        um, uc = _kf_update(self.mean, self.cov, z)
        self.mean = rnd(np.where(matched_t[..., None], um,
                               self.mean).astype(F32))
        self.cov = rnd(np.where(matched_t[..., None, None], uc,
                              self.cov).astype(F32))
        self.upd_ts = np.where(matched_t, ts[:, None], self.upd_ts)
        # 4. metrics of the matched tracks from the detection box
        g, gok = ground(self.h, bt)
        g = rnd(g)
        ok = matched_t & gok
        self.dist = np.where(ok, rnd(self._dist(g)),
                             np.where(matched_t, F32(np.nan), self.dist))
        wspd = rnd(self._history(ok, ts, g[..., 0], g[..., 1]))
        self.speed = np.where(ok, wspd,
                              np.where(matched_t, F32(np.nan), self.speed))
        # 5. prune stale tracks
        self.alive = self.alive & ((ts[:, None] - self.upd_ts)
                                   <= self.staleness)
        # 6. new tracks, ids in detection order
        is_new = dvalid & ~matched_d
        rank = np.cumsum(is_new, axis=1) - 1
        new_ids = self.next_id[:, None] + rank
        free = np.argsort(self.alive, axis=1, kind="stable")
        n_free = (~self.alive).sum(axis=1)
        fits = is_new & (rank < n_free[:, None])
        slot = np.where(fits, np.take_along_axis(free, np.clip(rank, 0, t - 1),
                                                 axis=1), -1)
        si, di = np.nonzero(fits)
        ti = slot[si, di]
        zn = _bbox_to_z(boxes)
        self.mean[si, ti] = 0
        self.mean[si, ti, :4] = zn[si, di]
        self.cov[si, ti] = P0
        self.alive[si, ti] = True
        self.ids[si, ti] = new_ids[si, di]
        self.pred_ts[si, ti] = ts[si]
        self.upd_ts[si, ti] = ts[si]
        self.dist[si, ti] = np.nan
        self.speed[si, ti] = np.nan
        self.head[si, ti] = 0
        self.length[si, ti] = 0
        self.next_id = self.next_id + is_new.sum(axis=1)
        live = self.alive.sum(axis=1)
        self.live_max = max(self.live_max, int(live.max(initial=0)))
        self.live_sum += int(live.sum())
        self.steps += s
        self.dropped += int((is_new & ~fits).sum())
        created = np.zeros((s, t), bool)
        created[si, ti] = True
        gd, gdok = ground(self.h, boxes)
        gd = rnd(gd)
        okc = np.zeros((s, t), bool)
        okc[si, ti] = gdok[si, di]
        gt = np.zeros((s, t, 2), F32)
        gt[si, ti] = gd[si, di]
        self.dist = np.where(okc, rnd(self._dist(gt)),
                             np.where(created, F32(np.nan), self.dist))
        self._history(okc, ts, gt[..., 0], gt[..., 1])
        # 7. per-detection outputs
        trk = np.maximum(det2trk, 0)
        ids = np.where(matched_d, np.take_along_axis(self.ids, trk, axis=1),
                       np.where(is_new, new_ids, 0))
        sl = np.maximum(slot, 0)
        dist = np.where(matched_d, np.take_along_axis(self.dist, trk, axis=1),
                        np.where(fits, np.take_along_axis(self.dist, sl,
                                                          axis=1), np.nan))
        spd = np.where(matched_d, np.take_along_axis(self.speed, trk, axis=1),
                       np.where(fits, np.take_along_axis(self.speed, sl,
                                                         axis=1), np.nan))
        return (np.where(dvalid, ids, 0).astype(np.int32),
                np.where(dvalid, dist, np.nan).astype(F32),
                np.where(dvalid, spd * F32(3.6), np.nan).astype(F32))
