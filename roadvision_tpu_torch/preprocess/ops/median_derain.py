"""Median-blur "derain" op — the port of
``roadvision_tpu/preprocess/ops/median_derain.py``.

ksize normalised as in the reference (even → +1, clamp [3, 9]). The
three planes of the batch go through kernel K3 as one stack, so the
card sees one launch per batch.
"""
from __future__ import annotations

import torch

from ...ops.median import median_planes, normalize_ksize
from ..base import PreprocessOp


class MedianDerain(PreprocessOp):
    def __init__(self, **params):
        super().__init__(**params)
        self.ksize = normalize_ksize(int(params.get("ksize", 3)))

    def apply_planar(self, planes):
        x = torch.stack([p.to(torch.uint8) for p in planes])  # (3, ..., H, W)
        h, w = x.shape[-2], x.shape[-1]
        out = median_planes(x.reshape(-1, h, w), self.ksize).reshape(x.shape)
        return tuple(out.unbind(0))
