"""Realtime preview loop — the port of ``main_preview.py``.

Wires capture → preprocess → detect → track → geometry → overlay → compare
canvas → optional recording, with the reference's config gates and
soft-fail semantics, batched through the engine on the card (one device
round trip per batch). The preview window requires OpenCV; without it,
use --record or --max-frames for headless runs (q/Esc quit only applies
to the cv2 window).

With ``tpu.mesh.enable`` and several ``camera.sources`` it runs the camera
fleet (``runtime/multi_engine.py``) and shows the streams tiled in a
grid; ``analytics.enabled`` adds the lines, zones and stopped-vehicle
alerts to the overlay and logs their summary at the end.

Usage:
  python -m roadvision_tpu_torch.tools.preview [--config configs/default.yaml]
      [--max-frames N] [--record out.avi] [--no-show] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from ..analytics import Analytics
from ..config import load_config
from ..io_video import FPSMeter, VideoSource, make_writer
from ..runtime import MultiStreamEngine, PipelineEngine, build_sources
from ..runtime.multi_engine import devices_from_config
from ..utils import get_logger
from ..vis import make_canvas
from ..vis.annotate import annotate, fleet_canvas

log = get_logger("roadvision.preview")

try:
    import cv2  # type: ignore
    _HAS_CV2 = True
except Exception:
    cv2 = None
    _HAS_CV2 = False

# config sections safe to apply live (host-side overlay/preview knobs).
# Everything the engine was built from (camera geometry, preprocess
# chain, detector thresholds/model, tracker constants, tpu.*) needs a
# restart and is reported instead of silently ignored.
_HOT_SECTIONS = ("vis", "preview")


class ConfigWatcher:
    """Polling hot-reload of the YAML (reference README's future Module 8).

    ``poll()`` re-reads the file when its mtime changes and returns the
    fresh config dict, logging which hot sections changed and warning
    about changed cold sections that require a restart.
    """

    def __init__(self, path, cfg):
        self.path = Path(path) if path else None
        self.cfg = cfg
        self.mtime = self._mtime()

    def _mtime(self):
        try:
            return self.path.stat().st_mtime if self.path else None
        except OSError:
            return None

    def poll(self):
        m = self._mtime()
        if m is None or m == self.mtime:
            return None
        self.mtime = m
        try:
            fresh = load_config(str(self.path))
        except Exception as exc:
            log.warning("config reload failed (%s); keeping old", exc)
            return None
        hot = [k for k in _HOT_SECTIONS if fresh.get(k) != self.cfg.get(k)]
        cold = [k for k in fresh
                if k not in _HOT_SECTIONS and fresh.get(k) != self.cfg.get(k)]
        if hot:
            log.info("hot-reloaded config sections: %s", ", ".join(hot))
        if cold:
            log.warning("config sections %s changed but need a restart "
                        "(built into the device step)", ", ".join(cold))
        self.cfg = fresh
        return fresh if hot else None


def run_multi(args, cfg) -> int:
    """Multi-camera preview: ``tpu.mesh.enable`` + ``camera.sources``.
    The fleet's streams run batched on the card (or on each card of
    ``tpu.mesh.devices``); the preview tiles the per-stream overlays into
    one grid canvas, with one analytics aggregate and one trail renderer
    per stream."""
    cam_cfg = cfg.get("camera", {})
    preview_cfg = cfg.get("preview", {}) or {}
    record_cfg = preview_cfg.get("record", {}) or {}
    draw_cfg = (cfg.get("vis", {}) or {}).get("draw", {}) or {}

    sources = build_sources(cam_cfg, max_frames=args.max_frames)
    engine = MultiStreamEngine(
        cfg, num_streams=len(sources),
        devices=devices_from_config(cfg.get("tpu", {}) or {}, args.device))
    log.info("multi-stream mode: %d sources over %d device(s)",
             len(sources), len(engine.devices))
    fpsm = FPSMeter(alpha=0.1)
    ana_cfg = cfg.get("analytics", {}) or {}
    analytics = None
    if ana_cfg.get("enabled"):
        analytics = [Analytics(ana_cfg) for _ in sources]  # per stream

    writer = None
    gated = False
    min_det = int(record_cfg.get("min_detections", 1))
    if bool(record_cfg.get("enable", False)) or args.record:
        path = args.record or record_cfg.get("path", "out_compare.avi")
        writer = make_writer(path, fps=record_cfg.get("fps", 30),
                             quality=int(record_cfg.get("quality", 85)))
        gated = bool(record_cfg.get("events_only", False))
        if gated:
            from ..io_video import EventGatedWriter
            writer = EventGatedWriter(
                writer, pre_roll=int(record_cfg.get("pre_roll", 30)),
                post_roll=int(record_cfg.get("post_roll", 60)))
        log.info("recording to %s%s", path,
                 " (event-gated)" if gated else "")
    show = _HAS_CV2 and not args.no_show

    trails = None
    if int(draw_cfg.get("trails", 0)) > 0:
        from ..vis import TrailRenderer
        trails = [TrailRenderer(length=int(draw_cfg["trails"]))
                  for _ in sources]

    n_frames = 0
    labels = [f"CAM{i}" for i in range(len(sources))]
    try:
        for batch in engine.stream(sources, max_frames=args.max_frames):
            b = len(batch[0])
            lb_meta = engine.engine.lb_meta(*batch[0][0].proc.shape[:2])
            for i in range(b):
                fps = fpsm.tick(batch[0][i].ts)
                canvas, events = fleet_canvas(
                    batch, i, draw_cfg, lb_meta, labels,
                    fps=fps if preview_cfg.get("show_fps", True) else None,
                    analytics=analytics, trails=trails)
                trig = bool(events) or any(
                    len(st[i].detections) >= min_det for st in batch)
                if writer:
                    if gated:
                        writer.write_gated(canvas, trig)
                    else:
                        writer.write(canvas)
                if show:
                    cv2.imshow("Multi-Stream Preview", canvas)
                    if (cv2.waitKey(1) & 0xFF) in (27, ord("q")):
                        raise KeyboardInterrupt
                n_frames += 1
    except KeyboardInterrupt:
        pass
    finally:
        if writer:
            writer.release()
        for src in sources:
            src.release()
        if show:
            cv2.destroyAllWindows()
        log.info("processed %d frames x %d streams; stage times: %s",
                 n_frames, len(sources), engine.timer.summary())
        if engine.fleet_gate:
            log.info("fleet temporal gate: %d frame-slots coasted "
                     "(detector skipped fleet-wide while ALL streams "
                     "were static)", engine.gate_frames_coasted)
        if gated and writer is not None:
            log.info("event-gated recording: %s", writer.summary())
        if analytics is not None:
            log.info("analytics: %s", json.dumps(
                [a.summary() for a in analytics]))
            for a in analytics:
                a.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--record", default=None,
                    help="override preview.record.path and enable recording")
    ap.add_argument("--no-show", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "plain PyTorch path on the CPU")
    ap.add_argument("--state", default=None, metavar="PATH",
                    help="tracking-state checkpoint: loaded at start if "
                         "the file exists, saved on exit — lets a "
                         "long-running stream resume identities exactly")
    ap.add_argument("--watch-config", action="store_true",
                    help="hot-reload vis/preview sections when the config "
                         "file changes (other sections need a restart)")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    tpu_cfg = cfg.get("tpu", {}) or {}
    mesh_cfg = tpu_cfg.get("mesh", {}) or {}
    if bool(mesh_cfg.get("enable", False)) \
            and len(cfg.get("camera", {}).get("sources") or []) > 1:
        return run_multi(args, cfg)
    cam_cfg = cfg.get("camera", {})
    preview_cfg = cfg.get("preview", {})
    compare_cfg = preview_cfg.get("compare", {}) or {}
    record_cfg = preview_cfg.get("record", {}) or {}
    vis_cfg = cfg.get("vis", {}) or {}
    draw_cfg = vis_cfg.get("draw", {}) or {}

    vs = VideoSource(
        source=cam_cfg.get("source", 0),
        width=cam_cfg.get("width", 1280),
        height=cam_cfg.get("height", 720),
        fps_request=cam_cfg.get("fps_request", 30),
        backend=cam_cfg.get("backend", "auto"),
        num_frames=args.max_frames,
        device=args.device,
    )
    fpsm = FPSMeter(alpha=0.1)
    engine = PipelineEngine(cfg, device=args.device)
    if args.state and Path(args.state).exists():
        engine.load_state(args.state)
        log.info("resumed tracking state from %s", args.state)

    writer = None
    gated = False
    min_det = int(record_cfg.get("min_detections", 1))
    want_record = bool(record_cfg.get("enable", False)) or args.record
    if want_record:
        path = args.record or record_cfg.get("path", "out_compare.avi")
        writer = make_writer(path, fps=record_cfg.get("fps", 30),
                             quality=int(record_cfg.get("quality", 85)))
        gated = bool(record_cfg.get("events_only", False))
        if gated:
            from ..io_video import EventGatedWriter
            writer = EventGatedWriter(
                writer, pre_roll=int(record_cfg.get("pre_roll", 30)),
                post_roll=int(record_cfg.get("post_roll", 60)))
            log.info("recording to %s (event-gated: pre %s / post %s "
                     "frames)", path, record_cfg.get("pre_roll", 30),
                     record_cfg.get("post_roll", 60))
        else:
            log.info("recording to %s", path)

    want_compare = bool(compare_cfg.get("enable", True))
    layout = compare_cfg.get("layout", "h")
    divider_px = int(compare_cfg.get("divider_px", 4))
    show = _HAS_CV2 and not args.no_show

    watcher = ConfigWatcher(args.config, cfg) if args.watch_config else None

    ana_cfg = cfg.get("analytics", {}) or {}
    analytics = Analytics(ana_cfg) if ana_cfg.get("enabled") else None

    n_frames = 0
    tail_s = 0.0
    t_first = None
    trails = None
    try:
        for res in engine.stream(vs, max_frames=args.max_frames):
            if t_first is None:
                t_first = time.perf_counter()  # end-to-end clock starts
                # after the first result (kernel build/warm-up excluded)
            if watcher is not None and n_frames % engine.batch_size == 0:
                fresh = watcher.poll()
                if fresh is not None:
                    preview_cfg = fresh.get("preview", {}) or {}
                    compare_cfg = preview_cfg.get("compare", {}) or {}
                    draw_cfg = (fresh.get("vis", {}) or {}).get("draw",
                                                                {}) or {}
                    want_compare = bool(compare_cfg.get("enable", True))
                    layout = compare_cfg.get("layout", "h")
                    divider_px = int(compare_cfg.get("divider_px", 4))
            t_tail = time.perf_counter()
            proc = np.ascontiguousarray(res.proc)
            if not proc.flags.writeable or np.shares_memory(proc, res.raw):
                proc = proc.copy()   # no-preprocess path: keep RAW clean
            tr_n = int(draw_cfg.get("trails", 0))
            if tr_n > 0 and (trails is None
                             or trails.length != max(2, tr_n)):
                from ..vis import TrailRenderer
                trails = TrailRenderer(length=tr_n)
            ana_events = annotate(proc, res, draw_cfg,
                                  engine.lb_meta(*proc.shape[:2]),
                                  analytics, trails if tr_n > 0 else None)
            fps = fpsm.tick(res.ts)

            if want_compare:
                canvas = make_canvas(
                    res.raw, proc, layout=layout, divider_px=divider_px,
                    label_raw=compare_cfg.get("label_raw", "RAW"),
                    label_proc=compare_cfg.get("label_proc", "PROC"),
                    fps=fps, show_fps=bool(preview_cfg.get("show_fps", True)))
            else:
                canvas = proc

            if writer:
                if gated:
                    trig = (len(res.detections) >= min_det
                            or bool(ana_events))
                    writer.write_gated(canvas, trig)
                else:
                    writer.write(canvas)
            tail_s += time.perf_counter() - t_tail
            if show:
                cv2.imshow("Compare Preview" if want_compare else "Preview",
                           canvas)
                key = cv2.waitKey(1) & 0xFF
                if key in (27, ord("q")):
                    break
            n_frames += 1
    finally:
        if args.state:
            engine.save_state(args.state)
            log.info("saved tracking state to %s", args.state)
        if writer:
            writer.release()
        vs.release()
        if show:
            cv2.destroyAllWindows()
        log.info("processed %d frames; stage times: %s",
                 n_frames, engine.timer.summary())
        if gated and writer is not None:
            log.info("event-gated recording: %s", writer.summary())
        if analytics is not None:
            log.info("analytics: %s", json.dumps(analytics.summary()))
            analytics.close()
        if n_frames > 1 and t_first is not None:
            wall = time.perf_counter() - t_first
            log.info("sustained %.2f fps end-to-end (%d frames after "
                     "warmup); overlay%s tail %.2f ms/frame",
                     (n_frames - 1) / wall, n_frames - 1,
                     "+record" if writer else "",
                     tail_s / max(1, n_frames) * 1e3)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
