"""Time the engine of two checkouts in turns on one card.

    python -m roadvision_tpu_torch.tools.engine_ab --trees build/parent . . build/parent

Each entry of ``--trees`` is the root of a checkout that holds a
``roadvision_tpu_torch`` package (unpack a commit with ``git archive``
into a directory that ``.gitignore`` lists). For each, in the order
given, a fresh Python process started in that tree builds the 1080p ×
batch 8 pipeline of ``bench.py::_cfg`` and times, on frames held in host
memory, ``PipelineEngine.process_batch(want_proc=False)`` and
``PipelineEngine.stream(want_proc=False)``: ``--windows`` windows of
``--iters`` batches each after a warm-up, synchronised at both ends. It
uses only what every commit of the port has (``PipelineEngine``, the
config's ``DEFAULTS`` / ``merge``, ``SyntheticRoadSource``), so a parent
commit and a change can be compared within one call, as two calls may
land on two cards and two hosts. One JSON line per tree on stdout, with
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional

from .bench import card_line

PROGRAM = r'''
import json, sys, time
import numpy as np, torch
from roadvision_tpu_torch.config import DEFAULTS, merge
from roadvision_tpu_torch.io_video import SyntheticRoadSource
from roadvision_tpu_torch.runtime import PipelineEngine

model, iters, windows, warmup = sys.argv[1], *map(int, sys.argv[2:5])
H, W, B, FPS = 1080, 1920, 8, 30.0
cfg = merge(DEFAULTS, {
    "preprocess": {"enabled": True, "chain": [
        {"name": "CLAHEDehaze",
         "params": {"space": "YCrCb", "clip_limit": 2.0, "tile_grid": 8}},
        {"name": "MedianDerain", "params": {"ksize": 3}}]},
    "detect": {"enabled": True, "model": model, "conf_thres": 0.25,
               "iou_thres": 0.7, "max_det": 100,
               "classes_keep": [0, 2, 3, 5, 7]},
    "tracking": {"enabled": True, "max_staleness": 1.2, "min_hits": 3,
                 "iou_threshold": 0.35, "speed_window": 0.8},
    "geometry": {"enabled": True, "projector": {
        "type": "homography",
        "image_points": [[0, H], [W, H], [0, int(0.4 * H)],
                         [W, int(0.4 * H)]],
        "world_points": [[0, 0], [20, 0], [0, 120], [20, 120]],
        "origin": [10.0, 0.0], "max_distance": 1000.0}},
    "tpu": {"batch_size": B}})
torch.backends.cudnn.benchmark = True
engine = PipelineEngine(cfg, device="cuda")
src = SyntheticRoadSource(W, H, num_vehicles=6)
batches = [np.stack([src.render(k * B + i) for i in range(B)])
           for k in range(4)]


class Replay:
    def __init__(self):
        self.k = 0

    def read_batch(self, n):
        frames = batches[self.k % len(batches)][:n]
        ts = 1000.0 + (self.k * B + np.arange(len(frames))) / FPS
        self.k += 1
        return frames, ts, len(frames)


def timed(fn):
    vals = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = fn()
        torch.cuda.synchronize()
        vals.append(n / (time.perf_counter() - t0))
    return {"median": float(np.median(vals)), "min": min(vals),
            "max": max(vals), "windows": vals}


def by_batch(source, n):
    done = 0
    for _ in range(n):
        frames, ts, _ = source.read_batch(B)
        done += len(engine.process_batch(frames, ts, want_proc=False))
    return done


def by_stream(source, n):
    return sum(1 for _ in engine.stream(source, max_frames=n * B,
                                        want_proc=False))


out = {}
for name, fn in (("process_batch_fps", by_batch), ("stream_fps", by_stream)):
    engine.reset()
    source = Replay()
    fn(source, warmup)
    out[name] = timed(lambda: fn(source, iters))
print(json.dumps(out))
'''


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True,
                    help="checkout roots, timed in this order")
    ap.add_argument("--model", default="assets/yolov8n_synthetic_256.npz",
                    help="detector weights, relative to each tree")
    ap.add_argument("--iters", type=int, default=16,
                    help="batches per timed window")
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args(argv)
    card = card_line()
    for tree in args.trees:
        root = Path(tree).resolve()
        if not (root / "roadvision_tpu_torch").is_dir():
            raise FileNotFoundError(f"{root} holds no roadvision_tpu_torch")
        run = subprocess.run(
            [sys.executable, "-c", PROGRAM, args.model, str(args.iters),
             str(args.windows), str(args.warmup)],
            cwd=root, capture_output=True, text=True, timeout=1200)
        if run.returncode != 0:
            raise RuntimeError(f"{root}: the timing program failed\n"
                               f"{run.stderr[-2000:]}")
        line = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": str(tree), "card": card, "iters": args.iters,
                          **line}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
