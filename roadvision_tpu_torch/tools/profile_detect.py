"""Per-stage detection profiler — the port of ``tools/profile_detect.py``.

    python -m roadvision_tpu_torch.tools.profile_detect [--res 1080]
        [--batch 8] [--iters 8] [--warmup 2] [--size n]
        [--dtype bfloat16|float32] [--only letterbox,forward,nms,full]
        [--out P.json] [--device cuda|cpu]

Times the detect step's parts on random frames with a seeded random
YOLOv8 of ``--size``, as the JAX tool does: the letterbox (square, to
640), the forward with its DFL decode, NMS of the decoded candidates
(conf 0.25, IoU 0.7, max_det 100, pre-top-k 300, classes 0, 2, 3, 5, 7)
with the box rescale, and the whole detect step. Timing:
``utils/profiler.py::time_ms`` (chained calls between two CUDA events
after a warm-up; the host clock on the CPU, where the numbers are no
device figure). Each line also gives one output element as a probe.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..detect.yolo_torch import YOLOTorch
from ..utils.device import resolve_device
from ..utils.profiler import time_ms
from ..utils.resolutions import res_width


def _probe(out) -> float:
    while isinstance(out, (tuple, list)):
        out = out[0]
    return float(out.reshape(-1)[0])


def run(args) -> Dict[str, dict]:
    device = resolve_device(args.device)
    h, b = args.res, args.batch
    w = res_width(h)
    rng = np.random.RandomState(0)          # the JAX tool's frames
    frames = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3),
                                          dtype=np.uint8)).to(device)
    det = YOLOTorch({"model": f"yolov8{args.size}.pt", "imgsz": 640,
                     "rect": False, "compute_dtype": args.dtype,
                     "conf_thres": 0.25, "iou_thres": 0.7, "max_det": 100,
                     "classes_keep": [0, 2, 3, 5, 7]}, device=device)
    print(f"[profile] device={device} res={h}p batch={b} "
          f"yolov8{args.size} {args.dtype} (compute "
          f"{str(det.dtype).split('.')[-1]})", flush=True)
    want = set(args.only.split(",")) if args.only else None
    rows: Dict[str, dict] = {}

    def timed(key, name, fn):
        if want is not None and key not in want:
            return
        with torch.inference_mode():
            ms = time_ms(fn, device, args.iters, args.warmup)
            probe = _probe(fn())
        rows[name] = {"ms": ms, "probe": probe}
        print(f"[profile] {name:32s} {ms:9.3f} ms  (probe {probe:.6g})",
              flush=True)

    with torch.inference_mode():
        imgs, ratio, pad = det.letterbox(frames)
        raw = det.forward(imgs)
    timed("letterbox", f"letterbox {h}p->640",
          lambda: det.letterbox(frames)[0])
    timed("forward", f"yolov8{args.size} forward+decode",
          lambda: det.forward(imgs))
    timed("nms", "nms (300 cand) + rescale",
          lambda: det.postprocess(raw, ratio, pad, (h, w)))
    timed("full", "full detect step", lambda: det.run(frames))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=1080)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=8,
                    help="calls chained between the two timing events")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--size", type=str, default="n")
    ap.add_argument("--dtype", type=str, default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--only", type=str, default="",
                    help="comma list of: letterbox, forward, nms, full")
    ap.add_argument("--out", default=None, help="write the lines as JSON")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "plain PyTorch path on the CPU")
    args = ap.parse_args(argv)
    rows = run(args)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1) + "\n")
        print(f"[profile] wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
