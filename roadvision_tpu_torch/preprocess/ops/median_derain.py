"""Median-blur "derain" op — the port of
``roadvision_tpu/preprocess/ops/median_derain.py``.

ksize normalised as in the reference (even → +1, clamp [3, 9]). The
three planes of the batch go through kernel K3 as one stack, so the
card sees one launch per batch, on the full and on the sampled path.
"""
from __future__ import annotations

import torch

from ...ops.median import (median_blur_u8, median_planar,
                           median_planar_strided, normalize_ksize)
from ..base import PreprocessOp


class MedianDerain(PreprocessOp):
    def __init__(self, **params):
        super().__init__(**params)
        self.ksize = normalize_ksize(int(params.get("ksize", 3)))

    def supports_planar(self) -> bool:
        return True

    def apply_planar(self, planes):
        x = torch.stack([p.to(torch.uint8) for p in planes])  # (3, ..., H, W)
        return tuple(median_planar(x, self.ksize).unbind(0))

    def supports_planar_sampled(self) -> bool:
        return True

    def apply_planar_sampled(self, planes, plan_y, plan_x):
        x = torch.stack([p.to(torch.uint8) for p in planes])
        return tuple(median_planar_strided(x, self.ksize, plan_y, plan_x)
                     .unbind(0))

    def apply_batch(self, frames: torch.Tensor) -> torch.Tensor:
        return median_blur_u8(frames, self.ksize)
