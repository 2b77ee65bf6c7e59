"""Weather-robustness benchmark — the port of ``tools/eval_weather.py``.

    python -m roadvision_tpu_torch.tools.eval_weather [--frames 96]
        [--res 256] [--levels none,light,medium,heavy,rain,heavy+rain]
        [--modes off,on,auto] [--rain 0.02] [--gate-thresh 150]
        [--gate-stat span|pspan] [--gate-impulse 2.5] [--out W.json]
        [--device cuda|cpu]

The reference exists to make road perception work in bad weather: CLAHE
"dehaze" + median "derain" in front of the detector, with a low-contrast
auto-gate that engages the chain only when the scene needs it
(src/preprocess/pipeline.py:37-45), but it never measures whether the
chain helps. This tool does:

  synthetic road scenes with exact ground truth (``SyntheticRoadSource``)
  → fog at none / light / medium / heavy with the reference's own fog
  model (``augment/fog.py``), optionally plus impulse "rain" noise (the
  median op's target) → the shipped demo checkpoint → SORT → detection
  mAP@0.5 and MOTA / IDF1 / HOTA, for the preprocess chain OFF / ON /
  AUTO-gated, one JSON table (the JAX tool's schema).

The fog field is frozen in time (one synthesizer seed per level,
re-seeded per frame), so tracking quality measures the weather, not fog
flicker. Fog and the engine run on ``--device`` (the card unless "cpu"
is asked for); scenes, rain and scoring are host numpy. Nothing is
written unless ``--out`` names a file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..config import project_root
from ..utils.device import DeviceLike, resolve_device

DEMO_WEIGHTS = project_root() / "assets" / "yolov8n_synthetic_256.npz"
PRE_CHAIN = [
    {"name": "CLAHEDehaze",
     "params": {"space": "YCrCb", "clip_limit": 2.0, "tile_grid": 8}},
    {"name": "MedianDerain", "params": {"ksize": 3}},
]


def build_scene(n_frames: int, res: int, vehicles: int, seed: int
                ) -> Tuple[np.ndarray, List[list]]:
    """Clean frames (N, res, res, 3) u8 BGR + per-frame gt
    [(x1, y1, x2, y2, vehicle_id), ...]."""
    from ..io_video.capture import SyntheticRoadSource
    src = SyntheticRoadSource(res, res, num_vehicles=vehicles, seed=seed)
    frames = np.stack([src.render(i) for i in range(n_frames)])
    gt = [src.gt_boxes(i) for i in range(n_frames)]
    return frames, gt


def fog_level(frames: np.ndarray, level: str, seed: int,
              device: DeviceLike = None) -> np.ndarray:
    """Apply one fog level to every frame, temporally frozen: the
    synthesizer is re-seeded per frame so the atmospheric draw (β, glow,
    airlight scale, tint) is identical across the clip — fog that
    flickers per frame would charge the tracker for synthesis noise.
    Synthesized on ``device`` (the card by default)."""
    if level == "none":
        return frames
    from ..augment.fog import CLI_OVERRIDES, EnhancedFogSynthesizer
    device = resolve_device(device)
    out = np.empty_like(frames)
    for i in range(frames.shape[0]):
        # the reference's own offline tool's constructor overrides
        # (notably global_veil=0.5, reference tools/fog_batch.py:18-27):
        # the veil is what compresses the gray span the auto-gate reads
        synth = EnhancedFogSynthesizer(level=level, seed=seed,
                                       device=device, **CLI_OVERRIDES)
        out[i] = synth.synthesize(frames[i])[0]
    return out


def add_rain(frames: np.ndarray, density: float, seed: int) -> np.ndarray:
    """Impulse 'rain' noise: short bright 2-px vertical streaks at
    ``density`` fraction of pixels — the degradation the reference's
    MedianDerain op (src/preprocess/ops/median_derain.py) targets."""
    if density <= 0:
        return frames
    out = frames.copy()
    n, h, w = frames.shape[:3]
    for i in range(n):
        rng = np.random.RandomState((seed * 7919 + i * 104729) & 0x7FFFFFFF)
        k = max(1, int(density * h * w))
        ys = rng.randint(0, h - 1, k)
        xs = rng.randint(0, w, k)
        val = rng.randint(200, 256, (k, 1)).astype(np.uint8)
        out[i, ys, xs] = val
        out[i, ys + 1, xs] = val  # 2-px streak
    return out


def gray_spans(frames: np.ndarray, stat: str = "span") -> np.ndarray:
    """Per-frame gray contrast statistic, mirroring the auto-gate's —
    delegates to the pipeline's single host implementation
    (preprocess.pipeline.host_contrast_stats) so the report columns,
    the calibration tool, and the device gate can never diverge."""
    from ..preprocess.pipeline import host_contrast_stats
    return host_contrast_stats(frames, stat)


def impulse_stats(frames: np.ndarray) -> np.ndarray:
    """Per-frame impulse (rain) residual — delegates to the pipeline's
    single host implementation (host_impulse_stats), same reasoning as
    :func:`gray_spans`."""
    from ..preprocess.pipeline import host_impulse_stats
    return host_impulse_stats(frames)


def make_cfg(weights: str, res: int, mode: str, conf: float,
             gate_thresh: float, batch: int,
             gate_stat: str = "span",
             gate_impulse: float = 0.0) -> Dict:
    """Engine config per preprocess mode, mirroring
    configs/synthetic_demo.yaml (the shipped checkpoint's deployment)."""
    from ..config import DEFAULTS, merge
    if mode == "off":
        pre = {"enabled": False}
    elif mode == "on":
        pre = {"enabled": True, "chain": PRE_CHAIN,
               "auto_gate": {"enable_low_contrast_gate": False}}
    elif mode == "auto":
        pre = {"enabled": True, "chain": PRE_CHAIN,
               "auto_gate": {"enable_low_contrast_gate": True,
                             "contrast_thresh": gate_thresh,
                             "stat": gate_stat,
                             "impulse_thresh": gate_impulse or None}}
    else:
        raise ValueError(f"unknown preprocess mode {mode!r}")
    return merge(DEFAULTS, {
        "preprocess": pre,
        "detect": {"enabled": True, "backend": "ultralytics",
                   "model": weights, "imgsz": res, "conf_thres": conf,
                   "iou_thres": 0.7, "max_det": 20, "classes_keep": [2]},
        "tracking": {"enabled": True, "backend": "sort",
                     "max_staleness": 1.2, "min_hits": 3,
                     "iou_threshold": 0.35, "speed_window": 0.8},
        "geometry": {"enabled": False},
        "tpu": {"batch_size": batch, "track_slots": 32},
    })


def run_mode(cfg: Dict, frames: np.ndarray,
             device: DeviceLike = None) -> List[list]:
    """Frames through the engine's step on ``device``; per-frame
    Detection lists (the code path the preview drives)."""
    from ..runtime import PipelineEngine
    engine = PipelineEngine(cfg, device=device)
    b = engine.batch_size
    n = frames.shape[0]
    dets: List[list] = []
    for i in range(0, n, b):
        chunk = frames[i:i + b]
        if chunk.shape[0] < b:  # fixed shapes: pad the tail batch
            pad = b - chunk.shape[0]
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], pad, axis=0)])
        ts = (i + np.arange(b, dtype=np.float64)) / 30.0
        res = engine.process_batch(chunk, ts, want_proc=False)
        dets.extend(r.detections for r in res[:min(b, n - i)])
    return dets


def score(dets: List[list], gt: List[list]) -> Dict[str, float]:
    """Detection mAP@0.5 + recall + matched-confidence mean +
    MOTA/IDF1/HOTA from per-frame Detection lists against the synthetic
    ground truth. ``conf_matched_mean`` is the continuous detector-
    health signal: hit/miss metrics quantize away a confidence recovery
    that hasn't yet crossed the deployment threshold, but the chain's
    effect IS that recovery (measured: heavy fog drops matched conf
    ~0.84→0.58; the CLAHE chain restores ~0.78)."""
    from ..detect.eval import _iou_matrix, average_precision
    from ..track.eval import evaluate_all
    pb = [np.asarray([[d.x1, d.y1, d.x2, d.y2] for d in ds],
                     np.float64).reshape(-1, 4) for ds in dets]
    pc = [np.asarray([d.conf for d in ds], np.float64) for ds in dets]
    gb = [np.asarray([r[:4] for r in rows], np.float64).reshape(-1, 4)
          for rows in gt]
    map50 = average_precision(pb, pc, gb, iou_thres=0.5)
    matched_conf: List[float] = []
    n_match = 0
    total_gt = sum(len(g) for g in gb)
    for boxes, conf, gtb in zip(pb, pc, gb):
        iou = _iou_matrix(boxes.astype(np.float32), gtb.astype(np.float32))
        taken = np.zeros(len(gtb), bool)
        for i in np.argsort(-conf):  # greedy by confidence
            j = int(np.argmax(np.where(taken, -1.0, iou[i]))) \
                if len(gtb) else -1
            if j >= 0 and iou[i, j] >= 0.5 and not taken[j]:
                taken[j] = True
                n_match += 1
                matched_conf.append(float(conf[i]))
    pred_tracks = [[(d.x1, d.y1, d.x2, d.y2, int(d.track_id))
                    for d in ds if d.track_id is not None] for ds in dets]
    trk = evaluate_all(gt, pred_tracks, iou_thres=0.5)
    return {"map50": round(float(map50), 4),
            "recall50": round(n_match / max(1, total_gt), 4),
            "conf_matched_mean": round(float(np.mean(matched_conf))
                                       if matched_conf else 0.0, 4),
            "mota": round(float(trk["mota"]), 4),
            "idf1": round(float(trk["idf1"]), 4),
            "hota": round(float(trk["hota"]), 4),
            "id_switches": int(trk["id_switches"]),
            "misses": int(trk["misses"]),
            "false_positives": int(trk["false_positives"])}


def evaluate(args) -> Dict:
    frames, gt = build_scene(args.frames, args.res, args.vehicles,
                             args.seed)
    if args.gate_thresh == "auto":
        # the deployment contract: calibrate on representative CLEAN
        # content (here: the un-degraded scene), then evaluate every
        # weather level against the learned threshold — the same
        # resolution PreprocessPipeline.calibrate_gate performs from a
        # live stream's first batch / tools/calibrate_gate.py
        from ..preprocess import PreprocessPipeline
        pipe = PreprocessPipeline(
            {"enabled": True, "chain": PRE_CHAIN,
             "auto_gate": {"enable_low_contrast_gate": True,
                           "contrast_thresh": "auto",
                           "stat": args.gate_stat}}, device=args.device)
        args.gate_thresh = round(pipe.calibrate_gate(frames), 2)
        print(f"[eval_weather] gate_thresh auto-calibrated to "
              f"{args.gate_thresh} (stat={args.gate_stat}, clean scene)",
              file=sys.stderr)
    else:
        args.gate_thresh = float(args.gate_thresh)
    report: Dict = {
        "meta": {
            "frames": args.frames, "res": args.res,
            "vehicles": args.vehicles, "weights": args.weights,
            "conf_thres": args.conf, "gate_thresh": args.gate_thresh,
            "gate_stat": args.gate_stat,
            "gate_impulse": args.gate_impulse,
            "rain_density": args.rain, "seed": args.seed,
            "chain": "CLAHEDehaze(YCrCb,2.0,8) + MedianDerain(3)",
        },
        "levels": {},
    }
    for level in args.levels:
        t0 = time.time()
        # level spec: "<fog>" | "rain" | "<fog>+rain" — rain is the
        # impulse-noise degradation the MedianDerain op targets
        parts = [p for p in level.split("+") if p]
        base = "none" if parts == ["rain"] else parts[0]
        rain = args.rain if ("rain" in parts) else 0.0
        fogged = fog_level(frames, base, args.seed, args.device)
        fogged = add_rain(fogged, rain, args.seed)
        spans = gray_spans(fogged, args.gate_stat)
        imps = impulse_stats(fogged)
        run_mask = spans < args.gate_thresh
        if args.gate_impulse > 0:
            run_mask = run_mask | (imps >= args.gate_impulse)
        entry = {
            "gray_span_mean": round(float(spans.mean()), 1),
            "impulse_mean": round(float(imps.mean()), 2),
            # fraction of frames whose chain the auto-gate would RUN
            # (low contrast OR impulse-noise energy ⇒ chain engages)
            "gate_run_frac": round(float(run_mask.mean()), 3),
            "modes": {},
        }
        for mode in args.modes:
            dets = run_mode(make_cfg(args.weights, args.res, mode,
                                     args.conf, args.gate_thresh,
                                     args.batch, args.gate_stat,
                                     args.gate_impulse), fogged,
                            args.device)
            entry["modes"][mode] = score(dets, gt)
        report["levels"][level] = entry
        print(f"[eval_weather] level={level:<10s} "
              f"span={entry['gray_span_mean']:6.1f} "
              f"gate_run={entry['gate_run_frac']:5.1%} "
              + " | ".join(f"{m}: mAP50={v['map50']:.3f} "
                           f"R={v['recall50']:.3f} "
                           f"conf={v['conf_matched_mean']:.3f} "
                           f"MOTA={v['mota']:.3f} IDF1={v['idf1']:.3f}"
                           for m, v in entry["modes"].items())
              + f"  ({time.time() - t0:.1f}s)", file=sys.stderr)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--vehicles", type=int, default=6)
    ap.add_argument("--weights", default=str(DEMO_WEIGHTS))
    ap.add_argument("--levels",
                    default="none,light,medium,heavy,rain,heavy+rain",
                    help="comma list; each entry is a fog level, 'rain' "
                         "(impulse noise only), or '<fog>+rain'")
    ap.add_argument("--modes", default="off,on,auto")
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--gate-thresh", default="150.0",
                    help="auto-gate contrast threshold: the chain runs "
                         "on frames whose gray span is BELOW this "
                         "(clean scenes here span ~170; the reference-"
                         "tool fog compresses to ~135). 'auto' "
                         "calibrates it from the clean scene "
                         "(PreprocessPipeline.calibrate_gate)")
    ap.add_argument("--gate-stat", default="span",
                    choices=["span", "pspan"],
                    help="auto-gate statistic: 'span' is the reference-"
                         "exact max-min (blind to impulse noise and "
                         "thin fog); 'pspan' is the robust p99.5-p0.5")
    ap.add_argument("--gate-impulse", type=float, default=2.5,
                    help="impulse-residual threshold for the auto "
                         "mode's rain statistic (0 disables): the "
                         "chain ALSO runs on frames whose mean "
                         "|gray - median3| (stride-4 subsample) is >= "
                         "this. Measured split on this content: clean "
                         "<= 1.6 at every fog level, 2%% rain >= 2.7")
    ap.add_argument("--rain", type=float, default=0.02,
                    help="impulse-noise density (fraction of pixels) "
                         "used by levels that include '+rain'")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the JSON report")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "plain PyTorch path on the CPU")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    args.levels = [s.strip() for s in args.levels.split(",") if s.strip()]
    args.modes = [s.strip() for s in args.modes.split(",") if s.strip()]

    report = evaluate(args)
    text = json.dumps(report, indent=2)
    if args.out:
        Path(args.out).write_text(text + "\n")
        print(f"[eval_weather] wrote {args.out}", file=sys.stderr)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
