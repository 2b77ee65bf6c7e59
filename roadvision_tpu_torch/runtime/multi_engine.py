"""Config-driven multi-stream engine: camera fleets on one or more cards —
the counterpart of ``roadvision_tpu/runtime/multi_engine.py``.

The reference runs one camera per process. JAX runs S streams as one
step vmapped over a stream axis and sharded over a device mesh. Here
the streams are cut into contiguous groups, one group per card; each
group runs one fleet step (``parallel/inference.py``: the group's frames
folded into one batch for preprocess and the detector, then one tracker
scan over the stacked state, for every backend, GMC inside it) on its
own :class:`PipelineEngine`, which holds that card's copy of the
weights. Where that engine's ``step_mode`` is ``"graph"`` the fleet step
is captured once per (group, shape) and replayed every fleet batch
(``runtime/graph.py``); the groups' stacked states and GMC thumbnails
are then the graphs' state buffers, reset in place. Reached from the config
surface:

    camera:
      sources: [synthetic:road, traffic.mp4, rtsp://...]   # one per stream
    tpu:
      mesh: {enable: true, axis: data, devices: null}     # null = all cards

``tools/preview.py``, ``tools/serve.py``, ``api.Pipeline.streams`` and the
bench's ``streams`` mode construct a :class:`MultiStreamEngine` whenever
``tpu.mesh.enable`` is true and more than one source is configured.
Per-stream outputs equal S independent single-stream runs up to the
detector's reduction order at the folded batch size.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..detect.types import COCO_NAMES
from ..io_video.capture import VideoSource
from ..track.gmc import fresh_carry
from ..track.sort import SortState
from ..utils.device import DeviceLike, resolve_device, visible_devices
from ..utils.logging import get_logger
from ..utils.profiler import device_stages
from .engine import FrameResult, PipelineEngine, unpack_detections

log = get_logger("roadvision.multi")


def build_sources(cam_cfg: Dict[str, Any],
                  max_frames: Optional[int] = None) -> List[VideoSource]:
    """``camera.sources`` entries → VideoSource list.

    Each entry is either a bare source spec (string/int, inheriting the
    camera block's width/height/fps/backend) or a dict overriding any of
    those keys for that stream.
    """
    entries = cam_cfg.get("sources") or []
    if not entries:
        entries = [cam_cfg.get("source", 0)]
    out = []
    for e in entries:
        over = dict(e) if isinstance(e, dict) else {"source": e}
        out.append(VideoSource(
            source=over.get("source", cam_cfg.get("source", 0)),
            width=over.get("width", cam_cfg.get("width", 1280)),
            height=over.get("height", cam_cfg.get("height", 720)),
            fps_request=over.get("fps_request",
                                 cam_cfg.get("fps_request", 30)),
            backend=over.get("backend", cam_cfg.get("backend", "auto")),
            num_frames=max_frames,
        ))
    return out


def devices_from_config(tpu_cfg: Dict[str, Any],
                        device: DeviceLike = None) -> List[torch.device]:
    """``tpu.mesh`` section → the devices the fleet's groups run on (the
    counterpart of ``mesh_from_config``): ``tpu.mesh.devices`` cards, or
    every visible card when it is null; with ``device="cpu"``, that many
    groups on the CPU (one when null). Asking for more cards than are
    visible is a ``ValueError`` (JAX's ``make_mesh`` takes the first
    ones it has)."""
    mesh_cfg = tpu_cfg.get("mesh") or {}
    axis = str(mesh_cfg.get("axis", "data"))
    if axis not in ("data", "model"):
        raise ValueError(f"tpu.mesh.axis={axis!r} is not a mesh axis "
                         f"(available: ['data', 'model'])")
    n_dev = mesh_cfg.get("devices")
    devices = visible_devices(int(n_dev) if n_dev else None, device)
    # the streams ride the named axis; a (data, model) mesh has one
    # device along "model"
    return devices if axis == "data" else devices[:1]


class _Group:
    """A contiguous group of streams on one device, its engine and its
    carried state (track states and GMC's (S, G, G) thumbnails with their
    flag, made at the first batch; or the gate's carry)."""

    def __init__(self, engine: PipelineEngine, lo: int, hi: int):
        self.engine = engine
        self.lo, self.hi = lo, hi
        self.steps: Dict[tuple, Any] = {}
        self.gate_carry = None
        self.clear()

    def clear(self) -> None:
        """No state: the next batch makes it anew."""
        self._step_state = None
        self.states: Optional[SortState] = None
        self.gmc_prev: Optional[torch.Tensor] = None
        self.gmc_valid: Optional[torch.Tensor] = None

    def init_state(self, init_states) -> None:
        """Fresh track states and GMC carry: made at the first batch,
        copied into the same tensors after (a captured graph holds
        them)."""
        n = self.hi - self.lo
        fresh = init_states(n)
        if self.engine.gmc_enabled:
            fresh = (*fresh, *fresh_carry((n,), self.engine.device))
        self.store(fresh)

    def step_state(self):
        """The tensors the fleet step reads and writes, in
        ``PipelineEngine.step_state``'s layout; the same object on every
        call once made."""
        return self._step_state

    def store(self, state) -> None:
        """Copy a step's (or fresh) state, in :meth:`step_state`'s layout,
        into the group's tensors; the first call binds them."""
        if self._step_state is None:
            self._step_state = state
            if self.engine.gmc_enabled:
                n = len(SortState._fields)
                self.states = SortState(*state[:n])
                self.gmc_prev, self.gmc_valid = state[n:]
            else:
                self.states = state
            return
        with torch.inference_mode():
            for dst, src in zip(self._step_state, state):
                if src is not dst:
                    dst.copy_(src)


class MultiStreamEngine:
    """S-camera fleet over one or more devices, driven by the same config
    schema as :class:`PipelineEngine` (which it wraps for construction,
    soft-fail semantics and the per-stream step). ``devices`` overrides
    :func:`devices_from_config`: one group of streams per entry (tests lay
    two groups on the CPU). ``seed`` seeds the random weights a missing
    checkpoint falls back to, the same on every device."""

    def __init__(self, cfg: Dict[str, Any], num_streams: int,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 seed: int = 0):
        if num_streams < 1:
            raise ValueError("need at least one stream")
        tpu_cfg = cfg.get("tpu", {}) or {}
        devs = devices_from_config(tpu_cfg) if devices is None \
            else [resolve_device(d) for d in devices]
        self.devices = devs
        n = len(devs)
        # the streams split evenly over the devices: pad with throwaway
        # streams (their frames are a repeat of stream 0, their states
        # evolve but are never unpacked)
        self.padded_streams = -(-num_streams // n) * n
        if self.padded_streams != num_streams:
            log.warning(
                "%d streams over %d devices: padding to %d streams — round "
                "the stream count to a multiple for full utilisation",
                num_streams, n, self.padded_streams)
        per = self.padded_streams // n
        self.groups = [
            _Group(PipelineEngine(cfg, device=d, seed=seed), g * per,
                   (g + 1) * per) for g, d in enumerate(devs)]
        self.engine = self.groups[0].engine
        # detect.temporal_gate: GLOBAL fleet gating — coast only when ALL
        # streams are static (parallel/inference.py:GatedStreamStep)
        self.fleet_gate = self.engine._gate_cfg is not None
        # the engine's choice, for the fleet step: the gate makes the
        # engine eager already
        self.step_mode = self.engine.step_mode
        self.gate_frames_coasted = 0
        self.num_streams = num_streams
        self.batch_size = self.engine.batch_size
        self.timer = self.engine.timer
        self._batches = 0
        self._t0: Optional[float] = None

    @property
    def states(self):
        """The stacked track state of the streams (the first group's on
        several devices); None before the first batch."""
        return self.groups[0].states if not self.fleet_gate else (
            None if self.groups[0].gate_carry is None
            else self.groups[0].gate_carry[0])

    # ------------------------------------------------------------------
    def _step_for(self, grp: _Group, shape):
        if shape not in grp.steps:
            from ..parallel import inference
            build = inference.make_gated_stream_step if self.fleet_gate \
                else inference.make_stream_step
            grp.steps[shape] = build(grp.engine, shape)
        return grp.steps[shape]

    def _names(self) -> List[str]:
        det = self.engine.detector
        if det is not None:
            return [det.names.get(i, str(i)) for i in range(det.nc)]
        return list(COCO_NAMES)

    def upload(self, frames: np.ndarray):
        """Pad (S, B, H, W, 3) frames to the padded stream count and start
        each group's host→device copy through its engine's pinned ring."""
        s = frames.shape[0]
        if self.padded_streams != s:
            pad = self.padded_streams - s
            frames = np.concatenate(
                [frames, np.broadcast_to(frames[:1],
                                         (pad,) + frames.shape[1:])])
        return [g.engine.upload(frames[g.lo:g.hi]) for g in self.groups]

    # ------------------------------------------------------------------
    def process_batch(self, frames: np.ndarray,
                      timestamps: np.ndarray) -> List[List[FrameResult]]:
        """(S, B, H, W, 3) BGR uint8 + (S, B) stamps → per-stream result
        lists. Tracking state persists on the devices across calls."""
        return self.collect_batch(self.dispatch_batch(frames, timestamps))

    def dispatch_batch(self, frames: np.ndarray, timestamps: np.ndarray,
                       device_frames=None):
        """Queue one fleet batch; ``device_frames`` is what :meth:`upload`
        returned for these frames, when a reader thread started the copy
        early. Stamps are rebased to ONE origin for the whole fleet, the
        earliest stamp of the first batch. The timer's spans ``dispatch``
        (the call), ``stamps``, ``replay`` and ``download`` inside it carry
        the batch's sequence number."""
        s = frames.shape[0]
        if s != self.num_streams:
            raise ValueError(f"expected {self.num_streams} streams, "
                             f"got {s}")
        seq = self._batches
        self._batches += 1
        with self.timer.stage("dispatch", seq):
            return self._dispatch(seq, frames, timestamps, device_frames)

    def _dispatch(self, seq, frames, timestamps, device_frames):
        timer = self.timer
        s, b, h, w = frames.shape[:4]
        ups = device_frames if device_frames is not None \
            else self.upload(frames)
        with timer.stage("stamps", seq):
            if self._t0 is None:
                self._t0 = float(np.min(timestamps))
            ts_rel = (np.asarray(timestamps) - self._t0).astype(np.float32)
            if self.padded_streams != s:
                pad = self.padded_streams - s
                ts_rel = np.concatenate(
                    [ts_rel, np.broadcast_to(ts_rel[:1], (pad, b))])
            ts_dev = [torch.from_numpy(
                np.ascontiguousarray(ts_rel[grp.lo:grp.hi])).to(
                    grp.engine.device, non_blocking=True)
                for grp in self.groups]
        for grp, up in zip(self.groups, ups):
            if up.ready is not None:
                torch.cuda.current_stream(grp.engine.device) \
                    .wait_event(up.ready)
        with timer.stage("replay", seq):
            fleet, coast = self._run_batch(ups, ts_dev, (b, h, w))
        handles = []
        with timer.stage("download", seq):
            for grp, up, outs in zip(self.groups, ups, fleet):
                # the step's marks ride the copy back (the gated fleet
                # step leaves none)
                outs = [*outs, None if self.fleet_gate
                        else grp.engine.stage_stamps]
                key = done = None
                if grp.engine.device.type == "cuda":
                    outs, key, done = grp.engine.download(outs)
                if up.slot is not None:
                    up.slot.consumed, up.slot.uploaded = done, False
                handles.append((outs, key, done))
        return frames, timestamps, handles, coast, seq

    def _run_batch(self, ups, ts_dev, shape):
        """Every group's fleet step on its frames and stamps → (outs a
        group, the gate's coast decision or None)."""
        fleet = []
        coast = None
        b, h, w = shape
        if self.fleet_gate:
            for grp in self.groups:
                step, init_carry = self._step_for(grp, (b, h, w))
                if grp.gate_carry is None:
                    grp.gate_carry = init_carry(grp.hi - grp.lo)
            steps = [self._step_for(g, (b, h, w))[0] for g in self.groups]
            motion = [st.motion(g.gate_carry, up.frames)
                      for st, g, up in zip(steps, self.groups, ups)]
            dev0 = self.engine.device
            fleet_max = torch.stack([m.to(dev0) for m, _ in motion]).max()
            coast = steps[0].decide(self.groups[0].gate_carry, fleet_max)
            for st, grp, up, t, (_, thumbs) in zip(steps, self.groups, ups,
                                                  ts_dev, motion):
                outs, grp.gate_carry = st.advance(grp.gate_carry, up.frames,
                                                  t, thumbs, coast)
                fleet.append(outs)
        else:
            for grp, up, t in zip(self.groups, ups, ts_dev):
                step, init_states = self._step_for(grp, (b, h, w))
                if grp.states is None:
                    grp.init_state(init_states)
                (outs,), new = grp.engine.run_step(
                    ("fleet", tuple(up.frames.shape)),
                    grp.engine.with_gmc_carry(step), grp.step_state(),
                    (up.frames, t))
                grp.store(new)
                fleet.append(outs)
        return fleet, coast

    def collect_batch(self, inflight) -> List[List[FrameResult]]:
        """Wait for an in-flight fleet batch and unpack its results; on
        the card, record each group's device stages from its step's
        marks."""
        frames, timestamps, handles, coast, seq = inflight
        s, b = frames.shape[:2]
        with self.timer.stage("device_step", seq):
            per_group, stamps = [], []
            for grp, (outs, key, done) in zip(self.groups, handles):
                if done is None:
                    per_group.append([t.numpy() for t in outs[:-1]])
                    continue
                done.synchronize()
                host = [None if t is None else t.numpy().copy()
                        for t in outs]
                grp.engine.recycle(key, outs)
                per_group.append(host[:-1])
                if host[-1] is not None:
                    stamps.append(host[-1])
            arrays = [np.concatenate(a) for a in zip(*per_group)]
        if coast:
            self.gate_frames_coasted += s * b   # the fleet coasted
        names = self._names()
        extra = getattr(self.engine.detector, "extra_field", None)
        results: List[List[FrameResult]] = []
        with self.timer.stage("host_unpack", seq):
            for si in range(s):
                per_frame = unpack_detections([a[si] for a in arrays], names,
                                              b, extra_field=extra)
                results.append([
                    FrameResult(frames[si, i], frames[si, i], per_frame[i],
                                float(timestamps[si, i]))
                    for i in range(b)])
        for group_stamps in stamps:
            for name, seconds in device_stages(group_stamps):
                self.timer.add(name, seconds, seq)
        return results

    # ------------------------------------------------------------------
    def stream(self, sources: Sequence[VideoSource],
               max_frames: Optional[int] = None
               ) -> Iterator[List[List[FrameResult]]]:
        """Lockstep streaming over S sources with the single-stream
        engine's overlap: a reader thread decodes and starts each fleet
        batch's upload, two batches in flight. Ends when ANY source ends
        (streams advance in lockstep so per-stream state stays aligned);
        a failing source is logged and ends the stream; sources of
        different frame shapes are a ``ValueError``."""
        if len(sources) != self.num_streams:
            raise ValueError(f"engine built for {self.num_streams} "
                             f"streams, got {len(sources)} sources")
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()
        failed: List[BaseException] = []

        def reader():
            count = 0
            try:
                while not stop.is_set():
                    n = self.batch_size
                    if max_frames is not None:
                        n = min(n, max_frames - count)
                        if n <= 0:
                            break
                    try:
                        with self.timer.stage("decode"):
                            batches = [src.read_batch(n) for src in sources]
                    except Exception as exc:   # a decode failure ends
                        log.warning("frame source failed: %s", exc)
                        break                  # the stream
                    m = min(mb for _, _, mb in batches)
                    if m == 0:
                        break
                    shapes = {f.shape[1:] for f, _, _ in batches}
                    if len(shapes) > 1:
                        raise ValueError(
                            f"streams must share one frame shape to run "
                            f"in lockstep, got {sorted(shapes)} — drop "
                            f"per-stream width/height overrides")
                    frames = np.stack([f[:m] for f, _, _ in batches])
                    ts = np.stack([t[:m] for _, t, _ in batches])
                    q.put((frames, ts, self.upload(frames)))
                    count += m
            except Exception as exc:   # handed to the consuming thread
                failed.append(exc)
            finally:
                q.put(None)

        thread = threading.Thread(target=reader, daemon=True)
        thread.start()
        pending: list = []
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                frames, ts, ups = item
                pending.append(self.dispatch_batch(frames, ts, ups))
                if len(pending) >= 2:
                    yield self.collect_batch(pending.pop(0))
            while pending:
                yield self.collect_batch(pending.pop(0))
            if failed:
                raise failed[0]
        finally:
            stop.set()
            for inflight in pending:    # abandoned: hand the buffers back
                for grp, (outs, key, done) in zip(self.groups, inflight[2]):
                    if done is not None:
                        done.synchronize()
                        grp.engine.recycle(key, outs)
            # empty the queue until the reader has ended (it may be
            # blocked in put); uploads nobody will dispatch free their slot
            deadline = time.monotonic() + 4.0
            while (thread.is_alive() or not q.empty()) \
                    and time.monotonic() < deadline:
                try:
                    item = q.get(timeout=0.05)
                except queue.Empty:
                    continue
                if item is not None:
                    for up in item[2]:
                        if up.slot is not None:
                            up.slot.uploaded = False
            thread.join(timeout=0.1)

    def reset(self) -> None:
        """A new set of streams: fresh track states, GMC thumbnails, gate
        carry and time origin; the coasted count back to 0. Where the
        fleet step replays a graph, the states and thumbnails keep their
        tensors (the graph's state) and take fresh values; elsewhere the
        next batch makes them anew."""
        for grp in self.groups:
            if grp.engine.step_mode == "graph" \
                    and grp.step_state() is not None:
                from ..parallel.inference import _init_states
                grp.init_state(lambda n, e=grp.engine: _init_states(e, n))
            else:
                grp.clear()
            grp.gate_carry = None
        self._t0 = None
        self.gate_frames_coasted = 0
