"""Preprocess op contract — the port of ``roadvision_tpu/preprocess/base.py``.

Ops take ``**params`` at construction and map BGR uint8 frames to BGR
uint8 frames. Three device paths, as in the JAX package:

  * :meth:`PreprocessOp.apply_batch` on channel-last ``(..., H, W, 3)``
    uint8 batches (every op has it);
  * :meth:`PreprocessOp.apply_planar` on (b, g, r) uint8 planes, where
    :meth:`PreprocessOp.supports_planar` says so: the pipeline then fuses
    the chain around one unpack and one repack;
  * :meth:`PreprocessOp.apply_planar_sampled`, the terminal-op path: the
    planes evaluated only at a ``(stride, offset, count)`` grid per axis,
    bit-equal to the full result sliced at that grid.

``__call__(image, device=None)`` takes and returns one numpy frame and
runs on the card unless the caller names another device.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


class PreprocessOp:
    """Base class: ``apply_batch(frames) -> frames`` on BGR uint8."""

    def __init__(self, **params: Any):
        self.params = params

    def apply_batch(self, frames: torch.Tensor) -> torch.Tensor:
        """(..., H, W, 3) uint8 → same shape uint8, on ``frames``' device."""
        raise NotImplementedError(
            f"{type(self).__name__} has no batch path")

    def supports_planar(self) -> bool:
        return False

    def apply_planar(self, planes):
        """(b, g, r) uint8 planes → (b, g, r) planes."""
        raise NotImplementedError(
            f"{type(self).__name__} has no planar path")

    def supports_planar_sampled(self) -> bool:
        return False

    def apply_planar_sampled(self, planes, plan_y, plan_x):
        """Planar path evaluated at the (stride, offset, count) grids."""
        raise NotImplementedError(
            f"{type(self).__name__} has no sampled planar path")

    def __call__(self, image: np.ndarray,
                 device: DeviceLike = None) -> np.ndarray:
        """Host single-frame API: on the card by default (raising without
        one), on ``device`` where the caller names it."""
        x = torch.from_numpy(np.ascontiguousarray(image)) \
            .to(resolve_device(device))
        return self.apply_batch(x).cpu().numpy()
