"""Dtype ladder: frames/s and accuracy per ``detect.compute_dtype`` — the
port of ``tools/dtype_ladder.py``.

    python -m roadvision_tpu_torch.tools.dtype_ladder [--frames 64]
        [--res 256] [--dtypes float32,bfloat16,int8,int8-static]
        [--calib-frames 16] [--fps] [--fps-iters 64] [--out D.json]
        [--device cuda|cpu]

Per dtype (float32 / bfloat16 / int8 / int8-static):

  * detection quality on the synthetic-GT scene with the shipped demo
    checkpoint: mAP@0.5, recall, matched-confidence mean (the scoring of
    ``tools/eval_weather.py``);
  * with ``--fps``, the device-resident pipeline frames/s at the demo
    scene, timed as the port bench's ``device_resident`` (frames rendered
    on the device, ``--fps-iters`` batches between two synchronisations
    after a warm-up).

On the CPU the port computes in float32 unless int8 (as its detector
does), so the bfloat16 row equals the float32 row there. Output: one
JSON table (the JAX tool's schema), written where ``--out`` says.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..utils.device import resolve_device
from .eval_weather import DEMO_WEIGHTS, build_scene, score

LADDER = ("float32", "bfloat16", "int8", "int8-static")


def _int_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


def resident_fps(engine, res: int, vehicles: int, iters: int):
    """(frames/s, detector FLOPs a frame): ``iters`` batches rendered on
    the device through the port bench's ``device_resident``, after two
    warm-up batches, between two synchronisations; FLOPs counted by
    ``torch.utils.flop_counter`` over the detector's forward of one
    batch (int8 products as ``torch._int_mm``, 2·M·N·K)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..io_video import DeviceSyntheticSource
    from .bench import device_resident

    dev = engine.device
    render = DeviceSyntheticSource(res, res, num_vehicles=vehicles, seed=0,
                                   device=dev).make_render_fn(
        engine.batch_size)
    engine.reset()
    device_resident(engine, render, 0, 2)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    n, _ = device_resident(engine, render, 2, iters)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fps = n / (time.perf_counter() - t0)
    det = engine.detector
    batch = render(0)
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten._int_mm: _int_mm_flops})
    with torch.inference_mode(), counter:
        det.forward(det.letterbox(batch)[0])
    return fps, counter.get_total_flops() / batch.shape[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--vehicles", type=int, default=6)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--weights", default=str(DEMO_WEIGHTS))
    ap.add_argument("--dtypes", default=",".join(LADDER))
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--calib-frames", type=int, default=16)
    ap.add_argument("--fps", action="store_true",
                    help="also measure device-resident frames/s per "
                         "dtype (slow on the CPU)")
    ap.add_argument("--fps-iters", type=int, default=64)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "plain PyTorch path on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    frames, gt = build_scene(args.frames, args.res, args.vehicles, seed=0)
    report = {"meta": {"frames": args.frames, "res": args.res,
                       "vehicles": args.vehicles, "weights": args.weights,
                       "conf_thres": args.conf,
                       "calib_frames": args.calib_frames}}
    rows = {}
    for dt in [s.strip() for s in args.dtypes.split(",") if s.strip()]:
        t0 = time.time()
        from ..config import DEFAULTS, merge
        from ..runtime import PipelineEngine
        cfg = merge(DEFAULTS, {
            "preprocess": {"enabled": False},
            "detect": {"enabled": True, "model": args.weights,
                       "imgsz": args.res, "conf_thres": args.conf,
                       "iou_thres": 0.7, "max_det": 20,
                       "classes_keep": [2],
                       "compute_dtype": "int8" if dt == "int8-static"
                                        else dt},
            "tracking": {"enabled": True},
            "tpu": {"batch_size": args.batch, "track_slots": 32},
        })
        engine = PipelineEngine(cfg, device=device)
        if dt == "int8-static":
            engine.detector.calibrate_int8(frames[:args.calib_frames])
        # accuracy through the same fused engine step as deployment
        b = engine.batch_size
        dets = []
        for i in range(0, frames.shape[0], b):
            chunk = frames[i:i + b]
            if chunk.shape[0] < b:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], b - chunk.shape[0], 0)])
            ts = (i + np.arange(b, dtype=np.float64)) / 30.0
            res = engine.process_batch(chunk, ts, want_proc=False)
            dets.extend(r.detections
                        for r in res[:min(b, frames.shape[0] - i)])
        row = score(dets, gt)
        if args.fps:
            fps, flops = resident_fps(engine, args.res, args.vehicles,
                                      args.fps_iters)
            row["fps"] = round(fps, 2)
            row["gflops_frame"] = round(flops / 1e9, 3)
        rows[dt] = row
        print(f"[dtype_ladder] {dt:<12s} mAP50={row['map50']:.4f} "
              f"R={row['recall50']:.4f} conf={row['conf_matched_mean']:.4f}"
              + (f" fps={row['fps']}" if args.fps else "")
              + f"  ({time.time() - t0:.1f}s)", file=sys.stderr)
    report["dtypes"] = rows
    text = json.dumps(report, indent=2)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
