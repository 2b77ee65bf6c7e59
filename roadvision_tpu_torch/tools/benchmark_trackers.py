"""Cross-backend tracking-quality benchmark: one table, every backend —
the port of ``tools/benchmark_trackers.py``.

    python -m roadvision_tpu_torch.tools.benchmark_trackers
        [--backends sort,bytetrack,ocsort,deepsort,botsort,strongsort]
        [--scenarios linear,occlusion,clutter,conf_dip,crossing,dense]
        [--seed 0] [--metric hota|idf1|mota] [--out T.json]
        [--device cuda|cpu]

A deterministic synthetic scenario suite, each scenario isolating one
classic failure mode, runs through every tracker backend via the host
``Tracker`` API (``update(dets, ts)``, each backend's step on
``--device``, the card unless "cpu" is asked for), is scored with the
full metric set (MOTA / IDF1 / HOTA, ``track/eval.py``) and printed as
a markdown table, with the JSON where ``--out`` says. The scenarios are
the JAX tool's, drawn from the same numpy generator.

The host list API carries no pixels, so the appearance backends
(deepsort / botsort / strongsort) run motion-only here; the suite still
exercises their start policies, two-stage association and NSA.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..utils import get_logger
from ..utils.device import DeviceLike, resolve_device

log = get_logger("roadvision.benchtrk")

BACKENDS = ("sort", "bytetrack", "ocsort", "deepsort", "botsort",
            "strongsort")


# --------------------------------------------------------------------------
# scenario suite: [(dt, boxes, confs, gt_ids)] per frame
# --------------------------------------------------------------------------

def scenario_linear(rng):
    """Three well-separated objects, clean detections — the sanity
    floor: every backend should be (near-)perfect."""
    seq = []
    for f in range(30):
        boxes, confs, gids = [], [], []
        for k in range(3):
            x = 10 + 12 * f
            y = 40 + 140 * k
            boxes.append((x, y, x + 50, y + 40))
            confs.append(0.9)
            gids.append(k + 1)
        seq.append((1 / 30, boxes, confs, gids))
    return seq


def scenario_occlusion(rng):
    """Move, vanish 6 frames, reappear stopped at the last-seen spot
    (the OC-SORT recovery case)."""
    seq = [(0.0, [(0, 0, 60, 40)], [0.9], [1])]
    for f in range(1, 6):
        seq.append((1 / 30, [(20 * f, 0, 60 + 20 * f, 40)], [0.9], [1]))
    for _ in range(6):
        seq.append((1 / 30, [], [], []))
    for _ in range(6):
        seq.append((1 / 30, [(100, 0, 160, 40)], [0.9], [1]))
    return seq


def scenario_clutter(rng):
    """One real object + transient low-confidence blips (the ByteTrack
    start-policy case)."""
    seq = []
    for f in range(18):
        boxes = [(20 + 10 * f, 200, 80 + 10 * f, 240)]
        confs, gids = [0.9], [1]
        if f % 3 == 1:
            x = float(rng.uniform(300, 500))
            y = float(rng.uniform(0, 120))
            boxes.append((x, y, x + 30, y + 25))
            confs.append(0.2)
            gids.append(None)
        seq.append((1 / 30, boxes, confs, gids))
    return seq


def scenario_conf_dip(rng):
    """Confidence dips below 0.5 during partial occlusion while the
    object brakes (the ByteTrack low-score rescue case). High-threshold
    backends lose the mid segment."""
    seq = []
    for f in range(20):
        x = 15 * min(f, 5) if f <= 13 else 15 * 5 + 8 * (f - 13)
        conf = 0.9 if (f < 5 or f > 13) else 0.25
        seq.append((1 / 30, [(x, 60, 70 + x, 120)], [conf], [1]))
    return seq


def scenario_crossing(rng):
    """Two converging courses passing close (the OCM direction case)."""
    seq = []
    for f in range(16):
        a = (10 + 18 * f, 100, 70 + 18 * f, 160)
        b = (280 - 18 * f, 104, 340 - 18 * f, 164)
        seq.append((1 / 30, [a, b], [0.9, 0.9], [1, 2]))
    return seq


def scenario_dense(rng):
    """Six jittery random-walk objects with 10% detector dropout —
    the aggregate stress case."""
    pos = rng.uniform(50, 500, (6, 2))
    vel = rng.uniform(-8, 8, (6, 2))
    seq = []
    for f in range(40):
        pos = pos + vel + rng.normal(0, 1.0, pos.shape)
        boxes, confs, gids = [], [], []
        for k in range(6):
            if rng.uniform() < 0.1:
                continue
            x, y = pos[k]
            jx, jy = rng.normal(0, 1.5, 2)
            boxes.append((x + jx, y + jy, x + jx + 46, y + jy + 36))
            confs.append(float(rng.uniform(0.55, 0.95)))
            gids.append(k + 1)
        seq.append((1 / 30, boxes, confs, gids))
    return seq


SCENARIOS = {
    "linear": scenario_linear,
    "occlusion": scenario_occlusion,
    "clutter": scenario_clutter,
    "conf_dip": scenario_conf_dip,
    "crossing": scenario_crossing,
    "dense": scenario_dense,
}


def run_backend(backend: str, seq, device: DeviceLike = None):
    from ..detect.types import Detection
    from ..track import build_tracker
    from ..track.eval import evaluate_all

    cfg = {"backend": backend, "max_staleness": 1.2, "speed_window": 0.8,
           "det_capacity": 16, "track_slots": 16, "iou_threshold": 0.3,
           "min_hits": 1, "new_track_thresh": 0.6}
    tracker = build_tracker(cfg, device=device)
    t = 1_700_000_000.0
    frames_gt, frames_pred = [], []
    for dt, boxes, confs, gids in seq:
        t += dt
        dets = [Detection(b[0], b[1], b[2], b[3], c, 2, "car")
                for b, c in zip(boxes, confs)]
        out = tracker.update(dets, t)
        frames_gt.append([(b[0], b[1], b[2], b[3], g)
                          for b, g in zip(boxes, gids) if g is not None])
        frames_pred.append([(d.x1, d.y1, d.x2, d.y2, d.track_id)
                            for d in out if d.track_id is not None])
    return evaluate_all(frames_gt, frames_pred)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backends", default=",".join(BACKENDS))
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metric", default="hota",
                    choices=["hota", "idf1", "mota"],
                    help="headline column for the table/means")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "plain PyTorch path on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    backends = [b.strip() for b in args.backends.split(",") if b.strip()]
    names = [s.strip() for s in args.scenarios.split(",") if s.strip()]
    unknown = [s for s in names if s not in SCENARIOS]
    if unknown:
        raise SystemExit(f"unknown scenarios: {unknown} "
                         f"(have {sorted(SCENARIOS)})")

    results = {b: {} for b in backends}
    for sname in names:
        seq = SCENARIOS[sname](np.random.default_rng(args.seed))
        for b in backends:
            results[b][sname] = run_backend(b, seq, device)
            log.info("%-10s %-10s mota=%.3f idf1=%.3f hota=%.3f ids=%d",
                     b, sname, results[b][sname]["mota"],
                     results[b][sname]["idf1"], results[b][sname]["hota"],
                     results[b][sname]["id_switches"])

    metric = args.metric
    header = "| backend | " + " | ".join(names) + f" | mean {metric} |"
    sep = "|" + "---|" * (len(names) + 2)
    rows = []
    for b in backends:
        vals = [results[b][s][metric] for s in names]
        cells = " | ".join(f"{v:.3f}" for v in vals)
        rows.append(f"| {b} | {cells} | {np.mean(vals):.3f} |")
    print(f"\n{metric.upper()} per scenario:")
    print("\n".join([header, sep] + rows))

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=2))
        log.info("wrote %s", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
