"""Whether what the timed path produced is correct: the program's
detections, track ids, distances and speeds of the window, judged
against the plain reference (``reference/``) after the window.

* The tracker and the geometry: the reference SORT is run over every
  frame of the window from the program's own detections (its outputs,
  read only to be judged) and must give the detections the same ids
  (``id_switches``, a count), distances (``dist_gap_m``, the widest
  gap) and speeds (``speed_gap_p99_kmh``); a value on one side and
  none on the other reads ``MISSING``.
* The preprocess chain and the detector: on a sample of the window's
  frames drawn from the seed (the last frame of stream 0 always in
  it), the reference runs the chain and the detector in float32 on the
  same frames: ``box_gap_p90_px`` and ``conf_gap_p90``
  (:func:`judge_detector`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .reference import detect as rdetect
from .reference import preprocess as rpre
from .reference.params import load_npz
from .reference.sort import Tracker, homography

MISSING = 1e9


def pack(batches: Sequence, cameras: Sequence[int], batch: int,
         max_det: int):
    """The window's per-frame Detection lists of ``cameras`` → arrays
    (len(cameras), F, D): boxes, conf, cls, valid, ids, dist, speed, in
    each frame's order."""
    frames, streams = len(batches) * batch, len(cameras)
    boxes = np.zeros((streams, frames, max_det, 4), np.float32)
    conf = np.zeros((streams, frames, max_det), np.float32)
    cls = np.zeros((streams, frames, max_det), np.int64)
    valid = np.zeros((streams, frames, max_det), bool)
    ids = np.zeros((streams, frames, max_det), np.int64)
    dist = np.full((streams, frames, max_det), np.nan, np.float32)
    speed = np.full((streams, frames, max_det), np.nan, np.float32)
    for n, results in enumerate(batches):
        for s, cam in enumerate(cameras):
            for j, res in enumerate(results[cam]):
                f = n * batch + j
                for k, d in enumerate(res.detections):
                    boxes[s, f, k] = (d.x1, d.y1, d.x2, d.y2)
                    conf[s, f, k] = d.conf
                    cls[s, f, k] = d.cls_id
                    valid[s, f, k] = True
                    ids[s, f, k] = d.track_id or 0
                    if d.distance_m is not None:
                        dist[s, f, k] = d.distance_m
                    if d.speed_kmh is not None:
                        speed[s, f, k] = d.speed_kmh
    return dict(boxes=boxes, conf=conf, cls=cls, valid=valid, ids=ids,
                dist=dist, speed=speed)


def _id_switches(prog: np.ndarray, ref: np.ndarray,
                 valid: np.ndarray) -> int:
    """Over each camera's frames in order: a detection whose program id
    was last seen paired with another reference id, or whose reference
    id with another program id, is a switch (SORT's greedy order makes
    near-tied duplicate tracks trade ids on last-bit differences; a
    tracker that loses its state trades them everywhere)."""
    switches = 0
    for s in range(prog.shape[0]):
        p2r: Dict[int, int] = {}
        r2p: Dict[int, int] = {}
        for f in range(prog.shape[1]):
            v = valid[s, f]
            for p, r in zip(prog[s, f][v].tolist(), ref[s, f][v].tolist()):
                switches += (p2r.get(p, r) != r) + (r2p.get(r, p) != p)
                p2r[p], r2p[r] = r, p
    return switches


def _gaps(a: np.ndarray, b: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """|a - b| of the valid entries; a value on one side only: MISSING."""
    a, b = a[valid], b[valid]
    gap = np.abs(a - b)
    gap[np.isnan(a) != np.isnan(b)] = MISSING
    return gap[~(np.isnan(a) & np.isnan(b))]


def replay(out: Dict, ts: np.ndarray, cfg: Dict, slots: int, h: int, w: int,
           low: bool = False):
    """The reference tracker over the detections of every frame → ids,
    distances and speeds (S, F, D), and the tracker (its counts of live
    and dropped tracks); ``ts`` (S, F) are the stamps as the program saw
    them."""
    pipe = cfg["pipeline"]
    proj = pipe["geometry"]["projector"]
    image = [[fx * w, fy * h] for fx, fy in proj["image_points_frac"]]
    geo = (homography(image, proj["world_points"]), proj["origin"],
           proj["max_distance"])
    streams, frames = out["valid"].shape[:2]
    tracker = Tracker(streams, slots, pipe["tracking"], geo, low)
    ids = np.zeros_like(out["ids"])
    dist = np.full_like(out["dist"], np.nan)
    speed = np.full_like(out["speed"], np.nan)
    d = max(1, int(out["valid"].sum(axis=2).max()))   # packed: valid first
    for f in range(frames):
        ids[:, f, :d], dist[:, f, :d], speed[:, f, :d] = tracker.step(
            out["boxes"][:, f, :d], out["valid"][:, f, :d], ts[:, f])
    return ids, dist, speed, tracker


def judge_tracker(out: Dict, ts: np.ndarray, cfg: Dict, slots: int,
                  h: int, w: int):
    """The reference tracker replayed over the program's detections of
    every frame, against the program's ids, distances and speeds →
    (readings, the reference tracker)."""
    ids, dist, speed, tracker = replay(out, ts, cfg, slots, h, w)
    v = out["valid"]
    speed_gaps = _gaps(speed, out["speed"], v)
    return {"id_switches": float(_id_switches(out["ids"], ids, v)),
            "dist_gap_m": float(_gaps(dist, out["dist"], v).max(
                initial=0.0)),
            "speed_gap_p99_kmh": float(np.percentile(speed_gaps, 99))
            if speed_gaps.size else 0.0}, tracker


def judge_detector(out: Dict, picks: List, frames_of, cfg: Dict,
                   device: torch.device, root) -> Dict[str, float]:
    """The reference chain and detector on the sampled (stream, frame)
    ``picks``; ``frames_of(picks)`` gives their (N, H, W, 3) uint8.

    Each program detection's gap is to the nearest reference candidate
    of its class (probability at least ``conf_thres - margin``): the
    least coordinate gap, and the probability gap at that candidate.
    Each of the reference's own detections' gap is to the nearest
    program detection of its class. The numbers are the 90th
    percentiles of the two kinds of gap together: bf16 moves the
    probability of a marginal query or anchor across the threshold now
    and then, which no limit on a widest gap could tell from a wrong
    answer, and a lost or altered detection moves the percentile."""
    model, chk = cfg["model"], cfg["check"]
    pipe = cfg["pipeline"]
    rules = pipe["detect"]
    clahe, med = (c["params"] for c in pipe["preprocess"]["chain"])
    p = load_npz(str(root / cfg["checkpoint"]), device)
    thr, margin = float(rules["conf_thres"]), float(chk["margin"])
    box_gaps: List[float] = []
    conf_gaps: List[float] = []

    def nearest(boxes, probs, b, c):
        if not len(boxes):
            box_gaps.append(MISSING)
            conf_gaps.append(MISSING)
            return
        gaps = np.abs(boxes - b).max(axis=1)
        j = int(gaps.argmin())
        box_gaps.append(float(gaps[j]))
        conf_gaps.append(abs(float(probs[j]) - float(c)))

    block = int(chk["block"])
    for i in range(0, len(picks), block):
        part = picks[i:i + block]
        with torch.no_grad():
            x = rpre.chain(frames_of(part), float(clahe["clip_limit"]),
                           int(clahe["tile_grid"]), int(med["ksize"]))
            cb, cs = rdetect.candidates(x, model, p)
        cb, cs = cb.cpu().numpy(), cs.cpu().numpy()
        for n, (s, f) in enumerate(part):
            sel = out["valid"][s, f]
            pb, pc, pk = (out["boxes"][s, f][sel], out["conf"][s, f][sel],
                          out["cls"][s, f][sel])
            for b, c, k in zip(pb, pc, pk):
                cand = cs[n, :, k] >= thr - margin
                nearest(cb[n][cand], cs[n, cand, k], b, c)
            rb, rc, rk = rdetect.detections(cb[n], cs[n], rules,
                                            nms=model["family"] == "yolov8")
            for b, c, k in zip(rb, rc, rk):
                mine = pk == k
                nearest(pb[mine], pc[mine], b, c)
    if not box_gaps:
        return {"box_gap_p90_px": 0.0, "conf_gap_p90": 0.0}
    return {"box_gap_p90_px": float(np.percentile(box_gaps, 90)),
            "conf_gap_p90": float(np.percentile(conf_gaps, 90))}


def sample_cameras(seed: int, streams: int, n: int) -> List[int]:
    """The ``n`` cameras whose answers are judged, drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 2203]))
    return sorted(int(c) for c in rng.choice(streams, size=min(n, streams),
                                             replace=False))


def sample_frames(seed: int, streams: int, frames: int, n: int) -> List:
    """``n`` (stream, frame) pairs of the window drawn from the seed, the
    last frame of the first stream among them."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 2204]))
    flat = rng.choice(streams * frames, size=min(n, streams * frames) - 1,
                      replace=False)
    picks = {(int(i) // frames, int(i) % frames) for i in flat}
    picks.add((0, frames - 1))
    return sorted(picks)
