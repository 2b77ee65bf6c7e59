"""Multi-stream (multi-camera) tracking over one stacked state — the
counterpart of ``roadvision_tpu/track/multi.py``.

A fleet of S camera streams keeps one :class:`SortState` whose fields
carry a leading stream axis. JAX lifts the single-stream step over that
axis with ``jax.vmap``. Here every step of ``make_sort_step`` takes the
stacked state itself, the default one and every backend's with its
strategy hooks (which see the stream axis too): the stream axis is a
batch dimension and one association launch a stage serves all S streams
(:func:`make_multi_step`). :func:`stream_states` and
:func:`stack_states` cut a stacked state into per-stream views and back.

IDs are per stream (each stream carries its own ``next_id``), matching S
independent trackers exactly.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from .sort import SortState, init_state, make_sort_step


def init_multi_state(num_streams: int, num_slots: int,
                     device=None) -> SortState:
    """A stacked SortState with a leading stream axis, on ``device`` (the
    card unless the caller names another)."""
    one = init_state(num_slots, device)
    return SortState(*[t.expand((num_streams,) + tuple(t.shape)).clone()
                       for t in one])


def stream_states(states: SortState) -> List[SortState]:
    """A stacked state → one state per stream (views of its slices)."""
    return [SortState(*[t[i] for t in states])
            for i in range(states.mean.shape[0])]


def stack_states(states: Sequence[Optional[SortState]]
                 ) -> Optional[SortState]:
    """Per-stream states → one stacked state (the inverse of
    :func:`stream_states`); None (no tracker) stays None."""
    if states[0] is None:
        return None
    return SortState(*[torch.stack(f) for f in zip(*states)])


def make_multi_step(step: Callable, with_projector: bool = False):
    """Lift a single-stream step (``track/registry.py::build_device_step``
    or ``make_sort_step``) over the stream axis: ``multi(states, boxes
    (S,D,4), cls (S,D), conf (S,D), valid (S,D), ts (S,), proj=None,
    emb=None (S,D,E), shift=None (S,2)) → (states', SortOutput stacked
    over S)``. The projector ``proj`` is shared by every stream, and is
    given exactly when ``with_projector``. The step runs once for all
    streams (every step takes a stacked state)."""
    def multi(states, boxes, cls_id, conf, valid, ts, proj=None, emb=None,
              shift=None):
        if (proj is not None) != with_projector:
            raise ValueError(f"the step was built with with_projector="
                             f"{with_projector}")
        return step(states, boxes, cls_id, conf, valid, ts, proj, emb,
                    shift)

    return multi


def make_multi_sort_step(iou_threshold: float, max_staleness: float,
                         speed_window: float, min_hits: int = 3,
                         with_projector: bool = False,
                         association: str = "greedy"):
    """step(states, boxes (S,D,4), cls (S,D), conf (S,D), valid (S,D),
    ts (S,), proj?) → (states, SortOutput stacked over S), as the JAX
    function: the stacked step, one association launch for all S
    streams; :func:`make_multi_step` lifts any other backend's step
    the same way."""
    return make_multi_step(
        make_sort_step(iou_threshold, max_staleness, speed_window, min_hits,
                       association=association), with_projector)
