"""YOLO11 as an ``nn.Module`` — the port of
``roadvision_tpu/models/yolo/yolo11.py``.

C3k2 blocks where YOLOv8 has C2f (each inner module a plain e=0.5
Bottleneck or a full C3k), C2PSA after SPPF (multi-head attention with a
depthwise positional encoding, then a 2× conv FFN, over half the
channels), and a Detect head at layer 23 whose class branch is
depthwise-separable (DWConv → 1×1, twice). Sizes n…x; m/l/x force C3k
blocks everywhere (the ultralytics parse_model rule).

Depthwise convolutions keep the JAX tree's (k, k, 1, C) kernels, here
(C, 1, k, k): ``Conv`` infers the group count from the input's width,
as ``_conv`` does. The attention mirrors ``_attention`` (yolo11.py:218)
step for step, dtype casts included, so bf16 rounds at the same places.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn as nn

from .yolov8 import (REG_MAX, SPPF, Conv, Detect, YOLOBase, _make_divisible,
                     _up2)

# depth_multiple, width_multiple, max_channels per YOLO11 size
SIZE_CFG_11 = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}


def arch_spec_11(size: str = "n", nc: int = 80) -> Dict[str, Any]:
    """Static architecture of one YOLO11 size (yolo11.py:53-74)."""
    depth, width, max_ch = SIZE_CFG_11[size]
    w = [_make_divisible(min(c, max_ch) * width, 8)
         for c in (64, 128, 256, 512, 1024)]
    n = max(1, round(2 * depth))
    force_c3k = size in ("m", "l", "x")
    c3k2 = {
        "2": (w[1], w[2], force_c3k, 0.25),
        "4": (w[2], w[3], force_c3k, 0.25),
        "6": (w[3], w[3], True, 0.5),
        "8": (w[4], w[4], True, 0.5),
        "13": (w[4] + w[3], w[3], force_c3k, 0.5),
        "16": (w[3] + w[3], w[2], force_c3k, 0.5),
        "19": (w[2] + w[3], w[3], force_c3k, 0.5),
        "22": (w[3] + w[4], w[4], True, 0.5),
    }
    ch_det = (w[2], w[3], w[4])
    c2 = max(16, ch_det[0] // 4, REG_MAX * 4)
    c3 = max(ch_det[0], min(nc, 100))
    return dict(size=size, nc=nc, widths=w, n=n, c3k2=c3k2,
                ch_det=ch_det, c2=c2, c3=c3)


class Bottleneck11(nn.Module):
    """3×3 c → c·e then 3×3 back to c, with the shortcut."""

    def __init__(self, c: int, e: float):
        super().__init__()
        ch = int(c * e)
        self.cv1 = Conv(c, ch, 3)
        self.cv2 = Conv(ch, c, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.cv2(self.cv1(x))


class C3k(nn.Module):
    """C3 with two e=1.0 3×3 bottlenecks."""

    def __init__(self, c: int):
        super().__init__()
        ch = int(c * 0.5)
        self.cv1 = Conv(c, ch, 1)
        self.cv2 = Conv(c, ch, 1)
        self.cv3 = Conv(2 * ch, c, 1)
        self.m = nn.ModuleList(Bottleneck11(ch, 1.0) for _ in range(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.cv1(x)
        for b in self.m:
            y1 = b(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=1))


class C3k2(nn.Module):
    """The C2f split/concat over C3k blocks or e=0.5 Bottlenecks."""

    def __init__(self, cin: int, cout: int, n: int, c3k: bool, e: float):
        super().__init__()
        c = int(cout * e)
        self.cv1 = Conv(cin, 2 * c, 1)
        self.cv2 = Conv((2 + n) * c, cout, 1)
        self.m = nn.ModuleList((C3k(c) if c3k else Bottleneck11(c, 0.5))
                               for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = list(self.cv1(x).chunk(2, dim=1))
        for b in self.m:
            parts.append(b(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class Attention(nn.Module):
    """Ultralytics ``Attention(dim, num_heads=dim // 64, attn_ratio=0.5)``."""

    def __init__(self, dim: int):
        super().__init__()
        nh = dim // 64
        kd = int(dim // nh * 0.5)
        self.qkv = Conv(dim, dim + nh * kd * 2, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, act=False, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        n, nh = hh * ww, c // 64
        hd = c // nh
        kd = int(hd * 0.5)
        # (B, C', H, W) → (B, N, heads, 2kd + hd), as the NHWC reshape
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(b, n, nh, 2 * kd + hd)
        q, k, v = qkv[..., :kd], qkv[..., kd:2 * kd], qkv[..., 2 * kd:]
        # qkv is f32 (no SiLU), so both products run in f32 as in JAX
        attn = torch.einsum("bihd,bjhd->bhij", q, k) * (kd ** -0.5)
        out = torch.einsum("bhij,bjhd->bihd", attn.softmax(dim=-1), v)
        out = out.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        vmap = v.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.proj(out + self.pe(vmap))


class PSABlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.attn = Attention(c)
        self.ffn = nn.ModuleList([Conv(c, 2 * c, 1),
                                  Conv(2 * c, c, 1, act=False)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.ffn[1](self.ffn[0](x))


class C2PSA(nn.Module):
    def __init__(self, c1: int, n: int):
        super().__init__()
        c = int(c1 * 0.5)
        self.cv1 = Conv(c1, 2 * c, 1)
        self.cv2 = Conv(2 * c, c1, 1)
        self.m = nn.ModuleList(PSABlock(c) for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, bpart = self.cv1(x).chunk(2, dim=1)
        for blk in self.m:
            bpart = blk(bpart)
        return self.cv2(torch.cat([a, bpart.to(a.dtype)], dim=1))


class DWPW(nn.Module):
    """Depthwise 3×3 then pointwise 1×1 (the head's DWConv → Conv)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dw = Conv(cin, cin, 3, groups=cin)
        self.pw = Conv(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))


class Detect11(Detect):
    """The legacy=False head: v8's box branch, a depthwise-separable
    class branch."""

    def __init__(self, ch_det, c2: int, c3: int, nc: int):
        super().__init__(ch_det, c2, c3, nc)
        self.cv3 = nn.ModuleList(
            nn.ModuleList([DWPW(ch, c3), DWPW(c3, c3),
                           Conv(c3, nc, 1, act=False)]) for ch in ch_det)


class YOLO11(YOLOBase):
    head_key = "23"

    def __init__(self, size: str = "n", nc: int = 80):
        super().__init__(size, nc)
        spec = arch_spec_11(size, nc)
        w, n = spec["widths"], spec["n"]
        layers: Dict[str, nn.Module] = {
            "0": Conv(3, w[0], 3, 2),
            "1": Conv(w[0], w[1], 3, 2),
            "3": Conv(w[2], w[2], 3, 2),
            "5": Conv(w[3], w[3], 3, 2),
            "7": Conv(w[3], w[4], 3, 2),
            "9": SPPF(w[4], w[4]),
            "10": C2PSA(w[4], n),
            "17": Conv(w[2], w[2], 3, 2),
            "20": Conv(w[3], w[3], 3, 2),
            "23": Detect11(spec["ch_det"], spec["c2"], spec["c3"], nc),
        }
        for i, (cin, cout, c3k, e) in spec["c3k2"].items():
            layers[i] = C3k2(cin, cout, n, c3k, e)
        self.layers = nn.ModuleDict(layers)

    def forward_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        L = self.layers
        y = L["2"](L["1"](L["0"](x)))
        p3 = L["4"](L["3"](y))
        p4 = L["6"](L["5"](p3))
        y = L["8"](L["7"](p4))
        p5 = L["10"](L["9"](y))
        h4 = L["13"](torch.cat([_up2(p5), p4], dim=1))
        out3 = L["16"](torch.cat([_up2(h4), p3], dim=1))
        out4 = L["19"](torch.cat([L["17"](out3), h4], dim=1))
        out5 = L["22"](torch.cat([L["20"](out4), p5], dim=1))
        return [out3, out4, out5]
