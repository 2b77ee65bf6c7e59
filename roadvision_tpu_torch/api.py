"""High-level library API — the port of ``roadvision_tpu/api.py``.

:class:`Pipeline` wraps config resolution, source opening, the batched
double-buffered engine, and optional recording behind three calls::

    import roadvision_tpu_torch as rvt

    pipe = rvt.Pipeline("configs/synthetic_demo.yaml")
    for r in pipe("clip.avi", max_frames=300):        # stream results
        print(r.ts, r.detections)

    rvt.Pipeline(detect={"enabled": True, "model": "w.npz"})\
        .process_video("in.avi", "out.avi")           # offline one-liner

    dets = pipe.detect_image(frame_bgr)               # single image

Everything stays the config-schema surface underneath: keyword sections
deep-merge over the loaded config the same way a user YAML merges over
DEFAULTS. The pipeline runs on the card unless ``device="cpu"`` is
passed; with no card and no such request the constructor raises.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

from .config import DEFAULTS, load_config, merge, sanitize_none
from .detect.types import Detection
from .io_video.capture import VideoSource
from .io_video.writer import make_writer
from .runtime.engine import FrameResult, PipelineEngine
from .utils.device import DeviceLike

ConfigLike = Union[None, str, Path, Dict[str, Any]]


class Pipeline:
    """Config-driven end-to-end pipeline (preprocess → detect → track →
    geometry) as a reusable library object.

    ``config`` is a YAML path, a dict (merged over DEFAULTS), or None
    (DEFAULTS / configs/default.yaml resolution); keyword sections are
    deep-merged on top, so ``Pipeline(detect={"enabled": False})``
    tweaks one knob without a file. ``device`` is the card by default,
    ``"cpu"`` for the plain PyTorch path; ``seed`` seeds the random
    weights a missing checkpoint falls back to.
    """

    def __init__(self, config: ConfigLike = None, device: DeviceLike = None,
                 seed: int = 0, **overrides: Any):
        if isinstance(config, dict):
            cfg = merge(DEFAULTS, sanitize_none(config))
        elif config is not None:
            cfg = load_config(str(config))
        else:
            try:
                cfg = load_config(None)
            except FileNotFoundError:  # no configs/ dir: pure defaults
                cfg = merge(DEFAULTS, {})
        if overrides:
            cfg = merge(cfg, sanitize_none(overrides))
        self.cfg = cfg
        self.engine = PipelineEngine(cfg, device=device, seed=seed)
        self._seed = seed
        self._multi_engines: Dict[int, Any] = {}   # fleets by stream count

    # ------------------------------------------------------------------
    def open_source(self, source: Union[None, int, str, VideoSource] = None,
                    max_frames: Optional[int] = None) -> VideoSource:
        """Open ``source`` with the config's camera geometry. None uses
        ``camera.source``; a VideoSource passes through unchanged."""
        if isinstance(source, VideoSource):
            return source
        cam = self.cfg.get("camera", {}) or {}
        return VideoSource(
            source=cam.get("source", 0) if source is None else source,
            width=cam.get("width", 1280),
            height=cam.get("height", 720),
            fps_request=cam.get("fps_request", 30),
            backend=cam.get("backend", "auto"),
            num_frames=max_frames,
            device=self.engine.device,
        )

    def __call__(self, source: Union[None, int, str, VideoSource] = None,
                 max_frames: Optional[int] = None,
                 want_proc: bool = True) -> Iterator[FrameResult]:
        """Stream :class:`FrameResult`s from ``source`` through the
        double-buffered batched engine (decode, transfer, and device
        compute overlapped)."""
        vs = self.open_source(source, max_frames)
        try:
            yield from self.engine.stream(vs, max_frames=max_frames,
                                          want_proc=want_proc)
        finally:
            vs.release()

    # ------------------------------------------------------------------
    def process_frames(self, frames: np.ndarray,
                       timestamps: Optional[np.ndarray] = None,
                       want_proc: bool = True) -> List[FrameResult]:
        """Run one (B, H, W, 3) uint8 BGR batch synchronously. Track
        state carries across calls (call :meth:`reset` between clips)."""
        frames = np.asarray(frames)
        if frames.ndim == 3:
            frames = frames[None]
        if timestamps is None:
            fps = float((self.cfg.get("camera", {}) or {})
                        .get("fps_request", 30) or 30)
            t0 = getattr(self, "_t_next", 0.0)
            timestamps = t0 + np.arange(frames.shape[0]) / fps
            self._t_next = float(timestamps[-1]) + 1.0 / fps
        return self.engine.process_batch(frames, np.asarray(timestamps,
                                                            np.float64),
                                         want_proc=want_proc)

    def detect_image(self, image: np.ndarray) -> List[Detection]:
        """Single-image detection (no tracking/geometry state touched)."""
        if self.engine.detector is None:
            raise RuntimeError("detection is disabled in this config "
                               "(detect.enabled: false)")
        return self.engine.detector.infer(np.asarray(image))

    # ------------------------------------------------------------------
    def process_video(self, source: Union[None, int, str, VideoSource] = None,
                      output: Optional[str] = None,
                      max_frames: Optional[int] = None,
                      draw: bool = True) -> Dict[str, Any]:
        """Offline convenience: stream ``source`` end-to-end, optionally
        record annotated frames to ``output`` (MJPEG-AVI/npy/y4m/mp4 by
        suffix), return a run summary."""
        from .vis import draw_detections

        writer = None
        n = 0
        track_ids: set = set()
        t0 = t1 = None
        try:
            for r in self(source, max_frames=max_frames, want_proc=draw):
                if output is not None and writer is None:
                    rec = (self.cfg.get("preview", {}) or {}) \
                        .get("record", {}) or {}
                    writer = make_writer(output,
                                         fps=rec.get("fps", 30),
                                         quality=int(rec.get("quality", 85)))
                if writer is not None:
                    canvas = r.proc.copy() if draw else r.raw
                    if draw:
                        draw_detections(canvas, r.detections)
                    writer.write(canvas)
                n += 1
                t1 = r.ts
                if t0 is None:
                    t0 = r.ts
                track_ids.update(d.track_id for d in r.detections
                                 if d.track_id is not None)
        finally:
            if writer is not None:
                writer.release()
        dur = (t1 - t0) if (n > 1 and t1 is not None) else 0.0
        return {"frames": n, "duration_s": round(float(dur), 3),
                "unique_tracks": len(track_ids),
                "output": output}

    # ------------------------------------------------------------------
    def streams(self, sources: Optional[list] = None,
                max_frames: Optional[int] = None) -> Iterator[list]:
        """Multi-camera lockstep streaming on the card (or on each card of
        ``tpu.mesh.devices``).

        ``sources`` is a list of source specs (or VideoSources); None
        uses ``camera.sources`` from the config. Each yielded item is
        the per-batch result: ``results[stream][frame]`` FrameResult
        lists (runtime/multi_engine.py). The fleet engine is built once
        per stream count; sources the caller passed as VideoSources are
        the caller's to release."""
        from .runtime.multi_engine import (MultiStreamEngine, build_sources,
                                           devices_from_config)

        cam = dict(self.cfg.get("camera", {}) or {})
        caller_owned = (sources is not None
                        and all(isinstance(s, VideoSource)
                                for s in sources))
        if caller_owned:
            vss = list(sources)
        else:
            if sources is not None:
                cam["sources"] = list(sources)
            vss = build_sources(cam, max_frames=max_frames)
        engine = self._multi_engines.get(len(vss))
        if engine is None:
            engine = self._multi_engines[len(vss)] = MultiStreamEngine(
                self.cfg, len(vss), devices=devices_from_config(
                    self.cfg.get("tpu", {}) or {}, self.engine.device.type),
                seed=self._seed)
        try:
            yield from engine.stream(vss, max_frames=max_frames)
        finally:
            if not caller_owned:
                for v in vss:
                    v.release()

    def reset(self) -> None:
        """Clear tracker state (between independent clips)."""
        self.engine.reset()
        self._t_next = 0.0
        for eng in self._multi_engines.values():
            eng.reset()
