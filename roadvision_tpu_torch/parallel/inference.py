"""Fleet inference on one card: camera streams batched through one step —
the counterpart of ``roadvision_tpu/parallel/inference.py``.

JAX vmaps the whole per-stream step over a leading stream axis and
shards that axis over the mesh's "data" axis. On one card, stream
sharding becomes stream batching: the S streams' frames are folded into
one batch of S·B for the preprocess chain, the letterbox, the detector
and NMS — so the CLAHE and median kernels launch once per fleet batch,
not once per stream. The tracker then scans the batch's frames once on
the stacked track state, every stream in each step, for every backend:
the strategy hooks take the stream axis, the re-id descriptors are
computed for all S·B frames at once, and GMC runs one gray thumbnail
over (S, B) frames and one phase correlation against the (S, G, G)
thumbnails the streams carry (one flag for all, as JAX's ``in_axes``
gives it). So one association launch a stage a frame serves all S
streams. Within a stream the batch axis is time, as in JAX. Several
cards each run such a step on a contiguous group of streams
(``runtime/multi_engine.py``), which replays it from a CUDA graph where
the engine's ``step_mode`` is ``"graph"``: every tracking backend, with
or without GMC.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..runtime.engine import _motion_score
from ..track.gmc import GMC_SIZE
from ..track.multi import init_multi_state
from ..track.sort import read_flag


def _fold(t: torch.Tensor) -> torch.Tensor:
    """(S, B, ...) → (S·B, ...)."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def _unfold(t: torch.Tensor, s: int) -> torch.Tensor:
    """(S·B, ...) → (S, B, ...)."""
    return t.reshape(s, t.shape[0] // s, *t.shape[1:])


def _init_states(engine, num_streams: int):
    return init_multi_state(num_streams, engine.track_slots, engine.device) \
        if engine.track_enabled else None


def make_stream_step(engine, shape: Tuple[int, int, int]):
    """Build (step, init_states) for S-stream inference on the engine's
    device — the counterpart of ``make_sharded_stream_step``.

    Args:
      engine: a PipelineEngine (its config defines the per-stream step).
      shape: per-stream (batch, H, W) — batch is the time axis.

    Returns:
      step(states, frames (S, B, H, W, 3) u8, ts (S, B) f32) → (outs
        stacked over S, states'); with GMC on, ``step(states, frames, ts,
        gprev, gvalid)`` with ``gprev`` the (S, G, G) thumbnails of the
        previous batch and ``gvalid`` () their flag (0 before the first
        batch) → (outs, states', thumbnails (S, G, G)). outs are the
        engine step's 7 arrays (8 with a task head), each (S, B, ...).
        Nothing it is given is written; on the card it writes the
        engine's ``stage_stamps``: the start, preprocess and the
        detector's pass done (``engine.front``) and the end, after the
        tracker tail with GMC and geometry.
      init_states(num_streams) → stacked SortState (None without a
        tracker).
    """
    b, h, w = shape
    gmc = bool(engine.gmc_enabled)

    @torch.inference_mode()
    def step(states, frames, ts, gprev=None, gvalid=None):
        s = frames.shape[0]
        engine.mark(0)
        _, dets = engine.front(_fold(frames), want_proc=False)
        if dets is None:
            outs = tuple(_unfold(a, s) for a in engine.empty_outs(s * b))
            engine.mark(3)
            return outs, states
        *dets4, extra = dets
        dets4 = tuple(_unfold(a, s) for a in dets4)
        shifts = grays = None
        if gmc:
            shifts, grays = engine._shifts(frames, gprev, gvalid)
        states, *tails = engine._tail(states, b, *dets4, ts, frames, shifts)
        outs = dets4 + tuple(tails)
        if extra is not None:
            outs = outs + (_unfold(extra, s),)
        engine.mark(3)
        return (outs, states, grays) if gmc else (outs, states)

    return step, lambda num_streams: _init_states(engine, num_streams)


class GatedStreamStep:
    """The fleet's temporal gate, in the three parts a fleet on several
    cards needs (:meth:`motion` on every card, one :meth:`decide` on the
    fleet maximum, :meth:`advance` on every card); calling the object
    runs the three on one card."""

    def __init__(self, engine, shape: Tuple[int, int, int]):
        if engine._gate_cfg is None:
            raise ValueError("detect.temporal_gate is not enabled")
        self.engine = engine
        self.b, self.h, self.w = shape
        self.thresh = engine._gate_cfg["thresh"]
        self.max_skip = engine._gate_cfg["max_skip"]

    def init_carry(self, num_streams: int):
        """(states, thumbnails (S, G, G), thumbnails valid, skips, held
        detections (boxes, conf, cls, valid) each (S, max_det, ...),
        held valid)."""
        eng = self.engine
        md, dev = eng.detector.max_det, eng.device
        gdets = (torch.zeros((num_streams, md, 4), device=dev),
                 torch.zeros((num_streams, md), device=dev),
                 torch.zeros((num_streams, md), dtype=torch.int32,
                             device=dev),
                 torch.zeros((num_streams, md), dtype=torch.bool,
                             device=dev))
        thumbs = torch.zeros((num_streams, GMC_SIZE, GMC_SIZE), device=dev)
        return (_init_states(eng, num_streams), thumbs, 0.0, 0, gdets, False)

    @torch.inference_mode()
    def motion(self, carry, frames):
        """Each stream's motion score against its own thumbnail → (the
        maximum over these streams, new thumbnails (S, G, G))."""
        _, thumbs, tvalid = carry[:3]
        scored = [_motion_score(frames[i], thumbs[i], tvalid)
                  for i in range(frames.shape[0])]
        return (torch.stack([sc for sc, _ in scored]).max(),
                torch.stack([t for _, t in scored]))

    def decide(self, carry, fleet_max: torch.Tensor) -> bool:
        """Coast only when the fleet's maximum is under the threshold,
        fewer than ``max_skip_batches`` batches have coasted in a row,
        and a held set exists: one host read, when the other two hold."""
        skips, gvalid = carry[3], carry[5]
        return bool(gvalid and skips < self.max_skip
                    and read_flag(fleet_max < self.thresh))

    @torch.inference_mode()
    def advance(self, carry, frames, ts, thumbs, coast: bool):
        """One fleet batch: coasted, every stream runs its tracker tail on
        its own held detections and the detector is skipped; else the
        folded batch runs preprocess and the detector, and each stream's
        final-frame detections become its held set. → (outs, carry')."""
        eng, b = self.engine, self.b
        states, _, _, skips, gdets, gvalid = carry
        s = frames.shape[0]
        if coast:
            dets4 = tuple(g[:, None].expand(s, b, *g.shape[1:])
                          for g in gdets)
            skips += 1
        else:
            fold = _fold(frames)
            boxes, conf, cls_id, valid, _ = eng.detector.run(
                eng.pipeline.apply_batch(fold))
            dets4 = tuple(_unfold(a, s) for a in (boxes, conf, cls_id, valid))
            gdets = tuple(a[:, -1] for a in dets4)
            skips = 0
        states, *tails = eng._tail(states, b, *dets4, ts, frames)
        return dets4 + tuple(tails), (states, thumbs, 1.0, skips, gdets,
                               gvalid or not coast)

    def __call__(self, carry, frames, ts):
        """→ (outs stacked over S, coasted, carry')."""
        fleet_max, thumbs = self.motion(carry, frames)
        coast = self.decide(carry, fleet_max)
        outs, carry = self.advance(carry, frames, ts, thumbs, coast)
        return outs, coast, carry


def make_gated_stream_step(engine, shape: Tuple[int, int, int]):
    """Fleet temporal gating: a global coast when ALL streams are static —
    the counterpart of ``make_sharded_gated_stream_step``.

    Per-stream motion scores reduce to a fleet-wide maximum; one host
    read of the decision (JAX branches inside the step with
    ``lax.cond``) either runs every stream's detector pass or coasts
    every stream on its own held detections. Motion on any camera wakes
    the whole fleet for that batch. As in JAX, the gated fleet step
    carries no GMC thumbnail (the gate and GMC exclude each other).

    Returns ``(step, init_carry)``:
      step(carry, frames (S,B,H,W,3) u8, ts (S,B)) → (outs stacked over
        S, coasted bool, carry'); ``step`` is a :class:`GatedStreamStep`.
      init_carry(num_streams) → the carry.
    """
    step = GatedStreamStep(engine, shape)
    return step, step.init_carry
