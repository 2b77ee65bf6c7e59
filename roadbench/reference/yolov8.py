"""YOLOv8 (Ultralytics ``yolov8.yaml``) forward, plain float32, from the
checkpoint's fused conv weights (BatchNorm folded in): Conv+SiLU stem,
C2f stages, SPPF, the FPN/PAN neck and the decoupled head with DFL box
regression at strides 8, 16, 32. Layer names follow the Ultralytics
indices (``"2.m.0.cv1"``)."""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from .params import Params, conv

REG_MAX = 16
STRIDES = (8, 16, 32)


def _c2f(x: torch.Tensor, p: Params, i: str, shortcut: bool) -> torch.Tensor:
    n = len({k.split(".")[2] for k in p if k.startswith(f"{i}.m.")})
    parts = list(conv(x, p, f"{i}.cv1", act="silu").chunk(2, dim=1))
    for j in range(n):
        h = conv(conv(parts[-1], p, f"{i}.m.{j}.cv1", act="silu"), p,
                 f"{i}.m.{j}.cv2", act="silu")
        parts.append(parts[-1] + h if shortcut else h)
    return conv(torch.cat(parts, dim=1), p, f"{i}.cv2", act="silu")


def _sppf(x: torch.Tensor, p: Params) -> torch.Tensor:
    y = conv(x, p, "9.cv1", act="silu")
    y1 = F.max_pool2d(y, 5, 1, 2)
    y2 = F.max_pool2d(y1, 5, 1, 2)
    y3 = F.max_pool2d(y2, 5, 1, 2)
    return conv(torch.cat([y, y1, y2, y3], dim=1), p, "9.cv2", act="silu")


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def features(x: torch.Tensor, p: Params) -> List[torch.Tensor]:
    """(B, 3, H, W) float → the three head inputs (/8, /16, /32)."""
    y = conv(conv(x, p, "0", 2, act="silu"), p, "1", 2, act="silu")
    y = _c2f(y, p, "2", True)
    p3 = _c2f(conv(y, p, "3", 2, act="silu"), p, "4", True)
    p4 = _c2f(conv(p3, p, "5", 2, act="silu"), p, "6", True)
    y = _c2f(conv(p4, p, "7", 2, act="silu"), p, "8", True)
    p5 = _sppf(y, p)
    h4 = _c2f(torch.cat([_up2(p5), p4], dim=1), p, "12", False)
    out3 = _c2f(torch.cat([_up2(h4), p3], dim=1), p, "15", False)
    out4 = _c2f(torch.cat([conv(out3, p, "16", 2, act="silu"), h4], dim=1),
                p, "18", False)
    out5 = _c2f(torch.cat([conv(out4, p, "19", 2, act="silu"), p5], dim=1),
                p, "21", False)
    return [out3, out4, out5]


def _branch(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    x = conv(x, p, f"{name}.0", act="silu")
    x = conv(x, p, f"{name}.1", act="silu")
    return conv(x, p, f"{name}.2")


def forward(x_nhwc: torch.Tensor, p: Params
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) RGB in [0, 1] → (boxes (B, N, 4) xyxy in input
    pixels, class probabilities (B, N, nc)), N anchors over the levels."""
    feats = features(x_nhwc.permute(0, 3, 1, 2).contiguous(), p)
    boxes, scores = [], []
    for lvl, (f, s) in enumerate(zip(feats, STRIDES)):
        b = _branch(f, p, f"22.cv2.{lvl}")
        c = _branch(f, p, f"22.cv3.{lvl}")
        bsz, _, h, w = b.shape
        gy, gx = torch.meshgrid(torch.arange(h, device=f.device),
                                torch.arange(w, device=f.device),
                                indexing="ij")
        ctr = torch.stack([gx, gy], -1).reshape(-1, 2).float() + 0.5
        dist = b.reshape(bsz, 4, REG_MAX, h * w).softmax(dim=2)
        dist = (dist * torch.arange(REG_MAX, device=f.device,
                                    dtype=torch.float32)[:, None]).sum(dim=2)
        dist = dist.transpose(1, 2)                       # (B, hw, 4) ltrb
        boxes.append(torch.cat([ctr - dist[..., :2], ctr + dist[..., 2:]],
                               dim=-1) * s)
        scores.append(torch.sigmoid(c.reshape(bsz, c.shape[1], h * w))
                      .transpose(1, 2))
    return torch.cat(boxes, dim=1), torch.cat(scores, dim=1)
