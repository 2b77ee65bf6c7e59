"""Tracker backend quality ladder — the port of ``tools/eval_trackers.py``:
which tracker should a deployment use?

    python -m roadvision_tpu_torch.tools.eval_trackers [--frames 96]
        [--res 256] [--backends sort,bytetrack,ocsort,deepsort,botsort,
        strongsort] [--scenes clean,heavy_fog] [--out T.json]
        [--device cuda|cpu]

The same rendered ground-truth scene and the demo detector go through
every backend (the engine path the preview drives) and are scored by
MOTA / IDF1 / HOTA / ID switches per backend, on the clean scene and
under heavy fog with the preprocess chain on, into one JSON table (the
JAX tool's schema). The re-id backends use the shipped embedder
(``assets/reid_synthetic.npz``) where it exists. Scene, fog and scoring
come from this package's ``tools/eval_weather.py``. Speed is not
measured here (``tools/benchmark_trackers.py`` and the bench time the
steps). Runs on ``--device``, the card unless "cpu" is asked for.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict

from ..config import project_root
from ..utils.device import resolve_device
from .eval_weather import (DEMO_WEIGHTS, PRE_CHAIN, build_scene, fog_level,
                           run_mode, score)


def make_cfg(weights: str, res: int, backend: str, conf: float,
             batch: int, pre_on: bool, min_hits: int = 3) -> Dict:
    """Engine config — eval_weather's deployment with the tracker
    backend swapped (and the appearance embedder for the re-id
    backends when the shipped checkpoint exists)."""
    from ..config import DEFAULTS, merge
    reid = project_root() / "assets" / "reid_synthetic.npz"
    tracking = {"enabled": True, "backend": backend,
                "max_staleness": 1.2, "min_hits": min_hits,
                "iou_threshold": 0.35, "speed_window": 0.8}
    if backend in ("deepsort", "botsort", "strongsort") and reid.exists():
        tracking["reid_weights"] = str(reid)
    return merge(DEFAULTS, {
        "preprocess": ({"enabled": True, "chain": PRE_CHAIN}
                       if pre_on else {"enabled": False}),
        "detect": {"enabled": True, "backend": "ultralytics",
                   "model": weights, "imgsz": res, "conf_thres": conf,
                   "iou_thres": 0.7, "max_det": 20, "classes_keep": [2]},
        "tracking": tracking,
        "geometry": {"enabled": False},
        "tpu": {"batch_size": batch, "track_slots": 32},
    })


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--vehicles", type=int, default=6)
    ap.add_argument("--weights", default=str(DEMO_WEIGHTS))
    ap.add_argument("--backends",
                    default="sort,bytetrack,ocsort,deepsort,botsort,"
                            "strongsort")
    ap.add_argument("--scenes", default="clean,heavy_fog",
                    help="clean | heavy_fog (fog + chain on) comma list")
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "plain PyTorch path on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    frames, gt = build_scene(args.frames, args.res, args.vehicles,
                             args.seed)
    scenes = {}
    for name in [s.strip() for s in args.scenes.split(",") if s.strip()]:
        if name == "clean":
            scenes[name] = (frames, False)
        elif name == "heavy_fog":
            scenes[name] = (fog_level(frames, "heavy", args.seed, device),
                            True)
        else:
            raise SystemExit(f"unknown scene {name!r}")

    report: Dict = {"meta": {
        "frames": args.frames, "res": args.res, "vehicles": args.vehicles,
        "weights": args.weights, "conf_thres": args.conf,
        "seed": args.seed,
        "note": "same engine path as WEATHER.json; speed per backend is "
                "measured separately by tools/benchmark_trackers.py "
                "(device step rates)"},
        "scenes": {}}
    for sname, (simg, pre_on) in scenes.items():
        rows = {}
        for backend in [b.strip() for b in args.backends.split(",")
                        if b.strip()]:
            t0 = time.time()
            dets = run_mode(make_cfg(args.weights, args.res, backend,
                                     args.conf, args.batch, pre_on), simg,
                            device)
            rows[backend] = score(dets, gt)
            print(f"[eval_trackers] {sname:<10s} {backend:<11s} "
                  f"MOTA={rows[backend]['mota']:.3f} "
                  f"IDF1={rows[backend]['idf1']:.3f} "
                  f"HOTA={rows[backend]['hota']:.3f} "
                  f"IDsw={rows[backend]['id_switches']} "
                  f"mAP50={rows[backend]['map50']:.3f} "
                  f"({time.time() - t0:.1f}s)", file=sys.stderr)
        report["scenes"][sname] = rows

    text = json.dumps(report, indent=2)
    if args.out:
        Path(args.out).write_text(text + "\n")
        print(f"[eval_trackers] wrote {args.out}", file=sys.stderr)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
