"""YOLOv5 (v6.0 layout) as an ``nn.Module`` — the port of
``roadvision_tpu/models/yolo/yolov5.py``.

6×6 stride-2 stem with pad 2, C3 stages, SPPF, FPN/PAN neck, and the
coupled anchor-based head at layer 24 with the v5 decode (yolov5.py:153):
xy = (2σ − 0.5 + grid) · stride, wh = (2σ)² · anchor, score = obj × cls.
Sizes n…x by the depth/width multiples. ``Conv`` and ``SPPF`` are
YOLOv8's (models/yolo/yolov8.py).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn as nn

from ...utils.device import device_constant
from .yolov8 import SPPF, STRIDES, Conv, YOLOBase, _make_divisible, _up2

SIZE_CFG = {
    "n": (0.33, 0.25),
    "s": (0.33, 0.50),
    "m": (0.67, 0.75),
    "l": (1.00, 1.00),
    "x": (1.33, 1.25),
}
NUM_ANCHORS = 3
# v5 anchor priors (w, h) in input pixels per level
ANCHORS = np.array([
    [[10, 13], [16, 30], [33, 23]],
    [[30, 61], [62, 45], [59, 119]],
    [[116, 90], [156, 198], [373, 326]],
], np.float32)


def arch_spec(size: str = "n", nc: int = 80) -> Dict[str, Any]:
    depth, width = SIZE_CFG[size]
    w = [_make_divisible(c * width, 8) for c in (64, 128, 256, 512, 1024)]
    d = {k: max(1, round(n * depth)) for k, n in (("d3", 3), ("d6", 6),
                                                  ("d9", 9))}
    return dict(size=size, nc=nc, widths=w, ch_det=(w[2], w[3], w[4]), **d)


class C3(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, shortcut: bool):
        super().__init__()
        c = cout // 2
        self.cv1 = Conv(cin, c, 1)
        self.cv2 = Conv(cin, c, 1)
        self.cv3 = Conv(2 * c, cout, 1)
        self.m = nn.ModuleList(nn.ModuleDict({"cv1": Conv(c, c, 1),
                                              "cv2": Conv(c, c, 3)})
                               for _ in range(n))
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        for b in self.m:
            h = b["cv2"](b["cv1"](a))
            a = a + h if self.shortcut else h
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class DetectV5(nn.Module):
    """One 1×1 conv per level to 3 anchors × (5 + nc)."""

    def __init__(self, ch_det, nc: int):
        super().__init__()
        self.m = nn.ModuleList(Conv(ch, NUM_ANCHORS * (5 + nc), 1, act=False)
                               for ch in ch_det)

    def forward(self, feats):
        return [m(f) for m, f in zip(self.m, feats)]


def decode(level_maps, nc: int):
    """Per-level NCHW raw maps → (boxes (B, N, 4) xyxy px, scores
    (B, N, nc)); anchors ordered (y, x, anchor) as the NHWC reshape."""
    boxes_l, scores_l = [], []
    for lvl, raw in enumerate(level_maps):
        bs, _, h, w = raw.shape
        stride = float(STRIDES[lvl])
        sig = torch.sigmoid(raw.permute(0, 2, 3, 1)
                            .reshape(bs, h, w, NUM_ANCHORS, 5 + nc))
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=raw.device),
            torch.arange(w, dtype=torch.float32, device=raw.device),
            indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]
        anchors = device_constant(ANCHORS[lvl].tolist(), torch.float32,
                                  raw.device)
        xy = (sig[..., 0:2] * 2.0 - 0.5 + grid) * stride
        wh = (sig[..., 2:4] * 2.0) ** 2 * anchors
        cls = sig[..., 5:] * sig[..., 4:5]
        boxes_l.append(torch.cat([xy - wh / 2, xy + wh / 2], -1)
                       .reshape(bs, -1, 4))
        scores_l.append(cls.reshape(bs, -1, nc))
    return torch.cat(boxes_l, 1), torch.cat(scores_l, 1)


class YOLOv5(YOLOBase):
    head_key = "24"

    def __init__(self, size: str = "n", nc: int = 80):
        super().__init__(size, nc)
        s = arch_spec(size, nc)
        w, d3, d6, d9 = s["widths"], s["d3"], s["d6"], s["d9"]
        self.layers = nn.ModuleDict({
            "0": Conv(3, w[0], 6, 2, pad=2),
            "1": Conv(w[0], w[1], 3, 2),
            "2": C3(w[1], w[1], d3, True),
            "3": Conv(w[1], w[2], 3, 2),
            "4": C3(w[2], w[2], d6, True),
            "5": Conv(w[2], w[3], 3, 2),
            "6": C3(w[3], w[3], d9, True),
            "7": Conv(w[3], w[4], 3, 2),
            "8": C3(w[4], w[4], d3, True),
            "9": SPPF(w[4], w[4]),
            "10": Conv(w[4], w[3], 1),
            "13": C3(2 * w[3], w[3], d3, False),
            "14": Conv(w[3], w[2], 1),
            "17": C3(2 * w[2], w[2], d3, False),
            "18": Conv(w[2], w[2], 3, 2),
            "20": C3(2 * w[2], w[3], d3, False),
            "21": Conv(w[3], w[3], 3, 2),
            "23": C3(2 * w[3], w[4], d3, False),
            "24": DetectV5(s["ch_det"], nc),
        })

    def forward_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        L = self.layers
        y = L["2"](L["1"](L["0"](x)))
        p3 = L["4"](L["3"](y))
        p4 = L["6"](L["5"](p3))
        p5 = L["9"](L["8"](L["7"](p4)))
        h5 = L["10"](p5)
        h4 = L["14"](L["13"](torch.cat([_up2(h5), p4], dim=1)))
        out3 = L["17"](torch.cat([_up2(h4), p3], dim=1))
        out4 = L["20"](torch.cat([L["18"](out3), h4], dim=1))
        out5 = L["23"](torch.cat([L["21"](out4), h5], dim=1))
        return [out3, out4, out5]

    def forward(self, x_nhwc: torch.Tensor):
        return decode(self.features_and_head(x_nhwc)[1], self.nc)


def head_bias_(det: DetectV5, nc: int) -> None:
    """The v5 head biases: obj log(8/(640/s)²), cls log(0.6/(nc − 0.99))."""
    for lvl, m in enumerate(det.m):
        b = np.zeros((NUM_ANCHORS, 5 + nc), np.float32)
        b[:, 4] = math.log(8.0 / (640.0 / STRIDES[lvl]) ** 2)
        b[:, 5:] = math.log(0.6 / (nc - 0.99))
        m.bias.copy_(torch.from_numpy(b.reshape(-1)))
