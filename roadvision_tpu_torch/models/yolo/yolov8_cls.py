"""YOLOv8-cls — the port of ``roadvision_tpu/models/yolo/yolov8_cls.py``.

The detection backbone's stem and C2f stages (layers 0-8, every size at
max_channels 1024) and the Classify head at layer 9: 1×1 Conv to 1280 →
global average pool → linear to nc. :class:`YOLOCls` is the predict
surface: centre square crop, bilinear resize with antialiasing (what
``jax.image.resize`` does by default), RGB [0, 1], softmax.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...utils.device import DeviceLike, resolve_device
from .yolov8 import SIZE_CFG, C2f, Conv, _make_divisible

C_HEAD = 1280       # Classify hidden width (size-invariant)
CLS_MAX_CH = 1024   # the classify yaml keeps 1024 for every size


def cls_spec(size: str = "n", nc: int = 1000) -> Dict[str, Any]:
    depth, width, _ = SIZE_CFG[size]
    w = [_make_divisible(min(c, CLS_MAX_CH) * width, 8)
         for c in (64, 128, 256, 512, 1024)]
    return dict(size=size, nc=nc, widths=w, n1=max(1, round(3 * depth)),
                n2=max(1, round(6 * depth)))


class Classify(nn.Module):
    def __init__(self, cin: int, nc: int):
        super().__init__()
        self.conv = Conv(cin, C_HEAD, 1)
        self.lin_w = nn.Parameter(torch.zeros(C_HEAD, nc))   # (in, out)
        self.lin_b = nn.Parameter(torch.zeros(nc))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = self.conv(x).float().mean(dim=(2, 3))
        return pooled @ self.lin_w + self.lin_b


class YOLOv8Cls(nn.Module):
    def __init__(self, size: str = "n", nc: int = 1000):
        super().__init__()
        s = cls_spec(size, nc)
        w, n1, n2 = s["widths"], s["n1"], s["n2"]
        self.size, self.nc = size, nc
        self.layers = nn.ModuleDict({
            "0": Conv(3, w[0], 3, 2), "1": Conv(w[0], w[1], 3, 2),
            "2": C2f(w[1], w[1], n1, True), "3": Conv(w[1], w[2], 3, 2),
            "4": C2f(w[2], w[2], n2, True), "5": Conv(w[2], w[3], 3, 2),
            "6": C2f(w[3], w[3], n2, True), "7": Conv(w[3], w[4], 3, 2),
            "8": C2f(w[4], w[4], n1, True), "9": Classify(w[4], nc)})

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) float [0, 1] → (B, nc) raw logits."""
        y = x_nhwc.permute(0, 3, 1, 2)
        for m in self.layers.values():
            y = m(y)
        return y


def init_cls_(model: YOLOv8Cls, gen: torch.Generator) -> None:
    """The linear layer's seeded init: normal · √(1 / 1280), zero bias
    (the convs are He-normal with the rest)."""
    lin = model.layers["9"].lin_w
    lin.copy_(torch.randn(lin.shape, generator=gen) * math.sqrt(1.0 / C_HEAD))


class YOLOCls:
    """``predict(bgr_u8) -> (cls_id, probs)``; config ``model``,
    ``imgsz`` (224), ``nc`` (1000, random init only). The card unless
    ``device="cpu"``."""

    def __init__(self, cfg: Dict[str, Any], device: DeviceLike = None,
                 seed: int = 0):
        from . import weights as W
        self.device = resolve_device(device)
        model_ref = str(cfg.get("model", "yolov8n-cls.pt"))
        self.imgsz = int(cfg.get("imgsz", 224))
        size = "n"
        for s in ("n", "s", "m", "l", "x"):
            if f"yolov8{s}" in model_ref.lower():
                size = s
        pth = Path(model_ref)
        sd = None
        if pth.exists():
            sd = W._load_torch(pth) if pth.suffix == ".pt" \
                else dict(np.load(pth))
        if sd is not None:
            tree = W.state_dict_to_params_cls(sd)
            size, self.loaded = W.infer_size_from_state_dict(sd), True
            nc = int(np.asarray(tree["9"]["lin_b"]).shape[0])
            model = YOLOv8Cls(size, nc)
            model.load_state_dict(W.params_from_jax(tree))
        else:
            model = W.random_model("v8", "classify", size,
                                   int(cfg.get("nc", 1000)), seed)
            self.loaded = False
        self.size, self.nc = size, model.nc
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def predict(self, bgr_u8):
        x = np.asarray(bgr_u8)
        if x.ndim == 3:
            x = x[None]
        b, h, w = x.shape[:3]
        s = min(h, w)
        y0, x0 = (h - s) // 2, (w - s) // 2
        crop = np.ascontiguousarray(x[:, y0:y0 + s, x0:x0 + s, ::-1])
        t = torch.from_numpy(crop).to(self.device).float().permute(0, 3, 1, 2)
        img = F.interpolate(t, size=(self.imgsz, self.imgsz),
                            mode="bilinear", align_corners=False,
                            antialias=True) / 255.0
        logits = self.model(img.permute(0, 2, 3, 1))
        probs = logits.softmax(dim=-1).cpu().numpy()
        return probs.argmax(-1), probs
