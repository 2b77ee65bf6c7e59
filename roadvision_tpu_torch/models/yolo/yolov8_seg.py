"""The segment head (YOLOv8-seg and YOLO11-seg) — the port of
``roadvision_tpu/models/yolo/yolov8_seg.py``.

On the detect layer (22 for v8, 23 for YOLO11) the head gains ``cv4``, a
per-level branch to ``nm`` = 32 mask coefficients per anchor, and
``proto``, a prototype head on the stride-8 feature: Conv k3 → 2×2
stride-2 transposed convolution (bias, no activation) → Conv k3 → 1×1
Conv to nm, giving nm prototypes at input/4. The transposed convolution
is ``_upsample_deconv2`` (yolov8_seg.py:98): with kernel 2 and stride 2
every output pixel takes exactly one tap, which is what
``F.conv_transpose2d`` computes; its kernel is kept (I, O, 2, 2), the
JAX tree's HWIO transposed.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .yolov8 import (SIZE_CFG, Conv, YOLOBase, _make_divisible, branch,
                     decode, run_branch)

NM = 32          # prototype / coefficient count (size-invariant)
NPR = 256        # prototype head width before width-multiple scaling


def seg_widths(model: YOLOBase) -> Dict[str, Any]:
    """The head's channel plan (yolov8_seg.py:50-62) for ``model``'s
    family and size."""
    if model.head_key == "23":
        from .yolo11 import SIZE_CFG_11
        _, width, max_ch = SIZE_CFG_11[model.size]
    else:
        _, width, max_ch = SIZE_CFG[model.size]
    ch3 = model.layers[model.head_key].cv2[0][0].weight.shape[1]
    return dict(npr=_make_divisible(min(NPR, max_ch) * width, 8),
                c4=max(ch3 // 4, NM), ch3=ch3)


class Proto(nn.Module):
    def __init__(self, cin: int, npr: int, nm: int):
        super().__init__()
        self.cv1 = Conv(cin, npr, 3)
        self.up_w = nn.Parameter(torch.zeros(npr, npr, 2, 2))
        self.up_b = nn.Parameter(torch.zeros(npr))
        self.cv2 = Conv(npr, npr, 3)
        self.cv3 = Conv(npr, nm, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Stride-8 feature (B, C, H/8, W/8) → prototypes (B, nm, H/4, W/4)."""
        y = self.cv1(x)
        # operands in the compute dtype, product and bias in f32: the
        # einsum with an f32 accumulator
        w = self.up_w.to(y.dtype)
        y = F.conv_transpose2d(y.float(), w.float(), stride=2) \
            + self.up_b[:, None, None]
        return self.cv3(self.cv2(y))


def attach_seg(model: YOLOBase) -> YOLOBase:
    """Add ``cv4`` and ``proto`` to the model's detect layer."""
    wd = seg_widths(model)
    head = model.layers[model.head_key]
    head.cv4 = nn.ModuleList(branch(m[0].weight.shape[1], wd["c4"], NM)
                             for m in head.cv2)
    head.proto = Proto(wd["ch3"], wd["npr"], NM)
    model.task = "segment"
    return model


def init_seg_(model: YOLOBase, gen: torch.Generator) -> None:
    """The transposed convolution's seeded init (the convs are He-normal
    with the rest): normal · √(2 / (npr · 2 · 2)), zero bias."""
    up = model.layers[model.head_key].proto.up_w
    up.copy_(torch.randn(up.shape, generator=gen)
             * math.sqrt(2.0 / (up.shape[0] * 4)))


def seg_outputs(model: YOLOBase, feats, outs):
    """→ (boxes (B, N, 4), scores (B, N, nc), coeffs (B, N, nm), protos
    (B, H/4, W/4, nm)), the JAX function's NHWC prototypes."""
    head = model.layers[model.head_key]
    boxes, scores = decode(outs, model.nc)
    coeffs = torch.cat([run_branch(head.cv4[lvl], f).flatten(2)
                        for lvl, f in enumerate(feats)], dim=2)
    protos = head.proto(feats[0]).permute(0, 2, 3, 1)
    return boxes, scores, coeffs.transpose(1, 2), protos
