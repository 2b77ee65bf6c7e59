"""YOLOv8 as an ``nn.Module`` — the port of
``roadvision_tpu/models/yolo/yolov8.py``, and what the families share.

Conv+SiLU stem, C2f stages, SPPF, FPN/PAN neck, decoupled Detect head
with DFL box regression at strides 8/16/32, sizes n/s/m/l/x. BatchNorm
is fused into each conv's weight and bias, as in the JAX package.
``YOLOBase`` holds the compute dtype and the NHWC boundary for YOLOv8,
YOLO11 (yolo11.py) and YOLOv5 (yolov5.py); a task head attached to the
detect layer (yolov8_seg.py, yolov8_pose.py, yolov8_obb.py) adds its
outputs after the boxes and scores, as ``forward_fn`` dispatches in
``yolo_jax.py``. ``Conv`` infers grouped (depthwise) convolutions from
the kernel's input width, as ``_conv`` does.

The public boundary keeps the JAX package's NHWC layout: ``forward``
takes (B, H, W, 3) float in [0, 1] and returns (boxes (B, N, 4) xyxy in
input pixels, scores (B, N, nc)). Inside, the NHWC input viewed as NCHW
is channels-last in memory, which is what cuDNN's fast convolutions want.

Compute dtype bf16 (default) or f32: conv weights are cast to it, biases
stay f32, and each conv adds its bias and applies SiLU in f32 before the
activation is cast back, as ``_conv`` does (yolov8.py:150-175). One
difference remains in bf16: ``F.conv2d`` rounds its output to bf16 before
the bias, where XLA keeps the f32 accumulator — compare the algorithm in
f32.

State-dict keys mirror the JAX parameter tree: JAX ``"2.m.0.cv1.w"``
(HWIO) is ``"layers.2.m.0.cv1.weight"`` (OIHW) here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

SIZE_CFG = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}
STRIDES = (8, 16, 32)
REG_MAX = 16


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(math.ceil(x / divisor) * divisor))


def arch_spec(size: str = "n", nc: int = 80) -> Dict[str, Any]:
    """Static architecture of one model size (yolov8.py:56-66)."""
    depth, width, max_ch = SIZE_CFG[size]
    w = [_make_divisible(min(c, max_ch) * width, 8)
         for c in (64, 128, 256, 512, 1024)]
    n1 = max(1, round(3 * depth))
    n2 = max(1, round(6 * depth))
    ch_det = (w[2], w[3], w[4])
    c2 = max(16, ch_det[0] // 4, REG_MAX * 4)
    c3 = max(ch_det[0], min(nc, 100))
    return dict(size=size, nc=nc, widths=w, n1=n1, n2=n2, ch_det=ch_det,
                c2=c2, c3=c3)


class Conv(nn.Module):
    """Fused Conv(+bias)(+SiLU), autopad k//2 unless ``pad`` is given
    (YOLOv5's 6×6 stem takes 2), NCHW. ``groups`` only shapes the
    weight: the forward infers the group count from the input's width
    over the weight's, as ``_conv`` does (yolov8.py:150-175), so a
    depthwise kernel (C, 1, k, k) runs depthwise."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 act: bool = True, groups: int = 1,
                 pad: Optional[int] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = stride
        self.pad = k // 2 if pad is None else pad
        self.act = act

    def forward(self, x: torch.Tensor, pad=None) -> torch.Tensor:
        """``pad`` overrides the padding: (rows, columns) for a band whose
        halo rows are already in ``x`` (parallel/spatial.py)."""
        x = x.to(self.weight.dtype)
        y = F.conv2d(x, self.weight, None, self.stride,
                     self.pad if pad is None else pad, 1,
                     x.shape[1] // self.weight.shape[1])
        y = y.float() + self.bias[:, None, None]
        if not self.act:
            return y                      # head outputs stay f32
        return F.silu(y).to(x.dtype)


class Bottleneck(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.cv1 = Conv(c, c, 3)
        self.cv2 = Conv(c, c, 3)


class C2f(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, shortcut: bool):
        super().__init__()
        c = cout // 2
        self.cv1 = Conv(cin, 2 * c, 1)
        self.cv2 = Conv((2 + n) * c, cout, 1)
        self.m = nn.ModuleList(Bottleneck(c) for _ in range(n))
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        parts = list(y.chunk(2, dim=1))
        for b in self.m:
            h = b.cv2(b.cv1(parts[-1]))
            parts.append(parts[-1] + h if self.shortcut else h)
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cv1 = Conv(cin, cin // 2, 1)
        self.cv2 = Conv((cin // 2) * 4, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        y1 = F.max_pool2d(y, 5, 1, 2)
        y2 = F.max_pool2d(y1, 5, 1, 2)
        y3 = F.max_pool2d(y2, 5, 1, 2)
        return self.cv2(torch.cat([y, y1, y2, y3], dim=1))


def branch(cin: int, c: int, cout: int) -> nn.ModuleList:
    """A head branch: Conv k3 → Conv k3 → 1×1 to ``cout`` (no SiLU)."""
    return nn.ModuleList([Conv(cin, c, 3), Conv(c, c, 3),
                          Conv(c, cout, 1, act=False)])


def run_branch(stages, x: torch.Tensor) -> torch.Tensor:
    for m in stages:
        x = m(x)
    return x


class Detect(nn.Module):
    """Decoupled head: box (``cv2``) and class (``cv3``) branches per
    level. The task heads attach a third per-level branch ``cv4`` (mask
    coefficients, keypoints or the angle) and the segment task a
    ``proto`` module (models/yolo/yolov8_{seg,pose,obb}.py)."""

    def __init__(self, ch_det: Sequence[int], c2: int, c3: int, nc: int):
        super().__init__()
        self.cv2 = nn.ModuleList(branch(ch, c2, 4 * REG_MAX) for ch in ch_det)
        self.cv3 = nn.ModuleList(branch(ch, c3, nc) for ch in ch_det)
        self.cv4: Optional[nn.ModuleList] = None
        self.proto: Optional[nn.Module] = None

    def forward(self, feats):
        return [(run_branch(self.cv2[lvl], f), run_branch(self.cv3[lvl], f))
                for lvl, f in enumerate(feats)]


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def anchor_points(hw_per_level: Sequence[Tuple[int, int]],
                  device: torch.device):
    """Anchor centres (N, 2) in grid units and per-anchor stride (N,)."""
    pts, strides = [], []
    for (h, w), s in zip(hw_per_level, STRIDES):
        yy, xx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device) + 0.5,
            torch.arange(w, dtype=torch.float32, device=device) + 0.5,
            indexing="ij")
        pts.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1))
        strides.append(torch.full((h * w,), float(s), dtype=torch.float32,
                                  device=device))
    return torch.cat(pts), torch.cat(strides)


def dfl_decode(box_logits: torch.Tensor) -> torch.Tensor:
    """(..., 4·REG_MAX) logits → (..., 4) expected ltrb distances."""
    probs = box_logits.reshape(box_logits.shape[:-1] + (4, REG_MAX)) \
        .softmax(dim=-1)
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=probs.device)
    return (probs * bins).sum(dim=-1)


def decode(level_outputs, nc: int):
    """Per-level NCHW head outputs → (boxes (B, N, 4), scores (B, N, nc))."""
    hw = [(b.shape[2], b.shape[3]) for b, _ in level_outputs]
    device = level_outputs[0][0].device
    pts, strides = anchor_points(hw, device)
    box_logits = torch.cat([b.flatten(2) for b, _ in level_outputs],
                           dim=2).transpose(1, 2)
    cls_logits = torch.cat([c.flatten(2) for _, c in level_outputs],
                           dim=2).transpose(1, 2)
    ltrb = dfl_decode(box_logits)
    x1y1 = (pts[None] - ltrb[..., :2]) * strides[None, :, None]
    x2y2 = (pts[None] + ltrb[..., 2:]) * strides[None, :, None]
    return torch.cat([x1y1, x2y2], dim=-1), torch.sigmoid(cls_logits)


class YOLOBase(nn.Module):
    """What the families share: ``layers`` keyed by the ultralytics
    indices, the compute dtype, and NHWC in / decoded outputs out.
    ``task`` is "detect" unless a task head was attached."""

    head_key = "22"

    def __init__(self, size: str, nc: int):
        super().__init__()
        self.size, self.nc, self.task = size, nc, "detect"
        self.compute_dtype = torch.float32

    def set_compute_dtype(self, dtype: torch.dtype) -> "YOLOBase":
        """Cast conv weights to ``dtype``; biases stay f32."""
        self.compute_dtype = dtype
        for m in self.modules():
            if isinstance(m, Conv):
                m.weight.data = m.weight.data.to(dtype)
                m.bias.data = m.bias.data.to(torch.float32)
        return self

    def features_and_head(self, x_nhwc: torch.Tensor):
        """NHWC [0, 1] input → (level features, per-level raw head
        outputs, NCHW f32)."""
        feats = self.forward_features(
            x_nhwc.permute(0, 3, 1, 2).to(self.compute_dtype))
        return feats, self.layers[self.head_key](feats)

    def forward(self, x_nhwc: torch.Tensor):
        """(B, H, W, 3) float [0, 1] → (boxes (B, N, 4), scores (B, N, nc))
        for the detect task, and the task's side outputs after them."""
        feats, outs = self.features_and_head(x_nhwc)
        if self.task == "detect":
            return decode(outs, self.nc)
        # task heads (as yolo_jax.py's forward_fn dispatch)
        if self.task == "segment":
            from .yolov8_seg import seg_outputs as fn
        elif self.task == "pose":
            from .yolov8_pose import pose_outputs as fn
        else:
            from .yolov8_obb import obb_outputs as fn
        return fn(self, feats, outs)


class YOLOv8(YOLOBase):
    """YOLOv8 detect model; ``layers`` keyed by the ultralytics indices."""

    def __init__(self, size: str = "n", nc: int = 80):
        super().__init__(size, nc)
        spec = arch_spec(size, nc)
        w, n1, n2 = spec["widths"], spec["n1"], spec["n2"]
        self.layers = nn.ModuleDict({
            "0": Conv(3, w[0], 3, 2),
            "1": Conv(w[0], w[1], 3, 2),
            "2": C2f(w[1], w[1], n1, True),
            "3": Conv(w[1], w[2], 3, 2),
            "4": C2f(w[2], w[2], n2, True),
            "5": Conv(w[2], w[3], 3, 2),
            "6": C2f(w[3], w[3], n2, True),
            "7": Conv(w[3], w[4], 3, 2),
            "8": C2f(w[4], w[4], n1, True),
            "9": SPPF(w[4], w[4]),
            "12": C2f(w[4] + w[3], w[3], n1, False),
            "15": C2f(w[3] + w[2], w[2], n1, False),
            "16": Conv(w[2], w[2], 3, 2),
            "18": C2f(w[3] + w[2], w[3], n1, False),
            "19": Conv(w[3], w[3], 3, 2),
            "21": C2f(w[4] + w[3], w[4], n1, False),
            "22": Detect(spec["ch_det"], spec["c2"], spec["c3"], nc),
        })

    def forward_features(self, x: torch.Tensor) -> List[torch.Tensor]:
        L = self.layers
        y = L["1"](L["0"](x))
        y = L["2"](y)
        p3 = L["4"](L["3"](y))
        p4 = L["6"](L["5"](p3))
        y = L["8"](L["7"](p4))
        p5 = L["9"](y)
        h4 = L["12"](torch.cat([_up2(p5), p4], dim=1))
        out3 = L["15"](torch.cat([_up2(h4), p3], dim=1))
        out4 = L["18"](torch.cat([L["16"](out3), h4], dim=1))
        out5 = L["21"](torch.cat([L["19"](out4), p5], dim=1))
        return [out3, out4, out5]


def he_normal_(model: nn.Module, gen: torch.Generator) -> None:
    """Seeded He-normal weights (fan-in = the kernel's input width × k²,
    as ``_init_conv``) and zero biases for every ``Conv``."""
    for m in model.modules():
        if isinstance(m, Conv):
            cout, cin, k, _ = m.weight.shape
            std = math.sqrt(2.0 / (cin * k * k))
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
            m.bias.zero_()


def head_bias_(det: Detect, nc: int) -> None:
    """The ultralytics head biases: box 1.0, cls log(5/nc/(640/stride)²)."""
    for lvl, s in enumerate(STRIDES):
        det.cv2[lvl][2].bias.fill_(1.0)
        det.cv3[lvl][2].bias.fill_(math.log(5.0 / nc / (640.0 / s) ** 2))


def build_model(params: Optional[Dict[str, Any]] = None, size: str = "n",
                nc: int = 80, seed: int = 0) -> YOLOv8:
    """A YOLOv8 from a JAX-layout parameter tree, or seeded random init
    (``weights.random_model``: the same recipe as ``init_params``; the
    numbers differ from ``jax.random``'s)."""
    from .weights import params_from_jax, random_model
    if params is None:
        return random_model("v8", "detect", size, nc, seed)
    model = YOLOv8(size, nc)
    model.load_state_dict(params_from_jax(params))
    return model
