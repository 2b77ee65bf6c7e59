"""Auto-gate threshold calibration one-shot — the port of
``tools/calibrate_gate.py``, over the port's
``preprocess/pipeline.py::calibrate_gate`` and its host statistics.

    python -m roadvision_tpu_torch.tools.calibrate_gate
        [--source synthetic:6] [--frames 96] [--width 256] [--height 256]
        [--stat span|pspan] [--ratio 0.85] [--pct 10]
        [--impulse-margin 1.6] [--json] [--device cuda|cpu]

The reference hard-codes its low-contrast gate threshold
(src/preprocess/pipeline.py:24-30, ``contrast_thresh: 20``), and the
threshold is in truth per deployment. This tool learns it from
representative CLEAN content: feed it a clip (or the synthetic source),
it reports the per-frame distribution of every gate statistic and emits
a ready-to-paste ``preprocess.auto_gate`` block:

  * ``contrast_thresh`` = ratio x percentile(pct) of the chosen contrast
    statistic over the clean frames;
  * ``impulse_thresh`` suggestion = margin x the clean impulse-residual
    p99 (the rain statistic).

The same resolution runs live when a config says
``contrast_thresh: "auto"`` (``PreprocessPipeline.calibrate_gate``
resolves it from the stream's first batch); this tool is the explicit,
many-frame version for production configs. The statistics are host
numpy, as in the JAX tool; the source and the pipeline are built on
``--device`` (a fogged synthetic source synthesizes its frames there).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..io_video.capture import VideoSource
from ..preprocess import PreprocessPipeline
from ..utils.device import resolve_device
from .eval_weather import impulse_stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default="synthetic:6",
                    help="clean-content source: any camera.source spec "
                         "(clip path, synthetic:N, imagedir, ...)")
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--stat", default="span", choices=["span", "pspan"])
    ap.add_argument("--ratio", type=float, default=0.85,
                    help="threshold = ratio x percentile(pct) of the "
                         "clean statistic")
    ap.add_argument("--pct", type=float, default=10.0)
    ap.add_argument("--impulse-margin", type=float, default=1.6,
                    help="impulse_thresh suggestion = margin x clean "
                         "impulse p99")
    ap.add_argument("--json", action="store_true",
                    help="print the report as JSON only")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    src = VideoSource(args.source, width=args.width, height=args.height,
                      device=device)
    frames = []
    for _ in range(args.frames):
        fr = src.read()
        if not fr.ok:
            break
        frames.append(fr.image)
    src.release()
    if not frames:
        print("no frames decoded from source", file=sys.stderr)
        return 1
    stack = np.stack(frames)

    # empty chain: only the HOST statistics run here; stats computed
    # once and shared between the threshold and the report
    pipe = PreprocessPipeline(
        {"enabled": True, "chain": [],
         "auto_gate": {"enable_low_contrast_gate": True,
                       "contrast_thresh": "auto", "stat": args.stat,
                       "auto_ratio": args.ratio, "auto_pct": args.pct}},
        device=device)
    stats = pipe.host_gate_stats(stack)
    thresh = pipe.calibrate_gate(stats=stats)
    imps = impulse_stats(stack)

    def pcts(a):
        return {f"p{p}": round(float(np.percentile(a, p)), 2)
                for p in (1, 10, 50, 90, 99)}

    report = {
        "frames": len(frames), "stat": args.stat,
        "contrast_stat_percentiles": pcts(stats),
        "impulse_stat_percentiles": pcts(imps),
        "recommended": {
            "enable_low_contrast_gate": True,
            "stat": args.stat,
            "contrast_thresh": round(thresh, 1),
            "impulse_thresh": round(
                args.impulse_margin * float(np.percentile(imps, 99)), 2),
        },
    }
    if args.json:
        print(json.dumps(report, indent=2))
        return 0
    print(f"calibrated over {len(frames)} clean frames "
          f"(stat={args.stat}):", file=sys.stderr)
    print(f"  contrast {pcts(stats)}", file=sys.stderr)
    print(f"  impulse  {pcts(imps)}", file=sys.stderr)
    print("paste into the config:", file=sys.stderr)
    print(json.dumps({"preprocess": {"auto_gate": report["recommended"]}},
                     indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
