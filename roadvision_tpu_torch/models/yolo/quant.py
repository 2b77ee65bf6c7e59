"""Int8 inference for the YOLO conv path — the port of
``roadvision_tpu/models/yolo/quant.py``.

The same symmetric scheme:

  * weights per output channel, scale = max|w| / 127, quantised once
    (:func:`quantize_model_` swaps every ``Conv`` for a :class:`QConv`
    holding ``w_i8``, ``w_scale`` and the f32 bias);
  * activations per tensor: dynamic (this tensor's abs-max / 127, a
    reduction on the device, never read by the host) unless the module
    holds a calibrated ``a_scale``;
  * int8 × int8 products summed in int32 — exact, as
    ``lax.conv(preferred_element_type=int32)``; an f32 convolution of
    int8 values is not (a 3×3×256 sum of 127² products passes 2²⁴);
  * dequantised as ``acc · (a_scale · w_scale) + b``: the scales'
    product first, then one fused multiply-add (:func:`dequantize`), as
    XLA compiles the JAX expression; then the conv's activation
    (``conv_i8``'s: SiLU for ``True`` or "silu", "relu", tanh-form
    "gelu", none for ``False`` / None), rounded once from f64. The
    output is f32 whatever the activation: the int8 paths compute
    everything around the quantised convs in f32.

The integer convolution (:func:`int8_conv`) is an im2col and
``torch._int_mm`` (a library product, as ``lax.conv`` is in the JAX
package), with K and N zero-padded to multiples of 8 and M to more than
16 rows — the card's cuBLASLt needs that, zeros are exact, and the CPU
takes the same path. Depthwise convolutions (YOLO11's head, C2PSA's
positional encoding) sum their nine taps as int32 elementwise products.

Calibration: JAX collects each conv's dynamic scale through a
module-global list while tracing. Here each :class:`QConv` observes
instead: between :func:`observe` and :func:`finish_calibration` a
forward folds its dynamic scale into a running abs-max on the device;
finishing bakes the running value as ``a_scale``. Nothing is retraced.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.activations import gelu
from .yolov8 import Conv


def _pad_to(t: torch.Tensor, dim: int, mult: int, least: int = 0):
    n = t.shape[dim]
    want = max(-(-n // mult) * mult, least)
    if want == n:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, want - n]
    return F.pad(t, pad)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 × (N, K) int8 → (M, N) int32, exact."""
    m, n = a.shape[0], w.shape[0]
    # row-major operands: cuBLASLt takes no other int8 layout (an im2col
    # view of a one-image batch can arrive with other strides)
    a = _pad_to(_pad_to(a, 1, 8), 0, 1, least=17).contiguous()
    w = _pad_to(_pad_to(w, 1, 8), 0, 8).contiguous()
    return torch._int_mm(a, w.t())[:m, :n]


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              pad: int = 0) -> torch.Tensor:
    """(B, C, H, W) int8 ⋆ (O, C / g, k, k) int8 → (B, O, Ho, Wo) int32,
    the group count inferred from the widths as ``conv_i8`` does."""
    b, c, h, wd = x.shape
    o, cg, k, _ = w.shape
    groups = c // cg
    if pad:
        x = F.pad(x, (pad, pad, pad, pad))
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    taps = [x[:, :, i:i + stride * (ho - 1) + 1:stride,
              j:j + stride * (wo - 1) + 1:stride]
            for i in range(k) for j in range(k)]
    if cg == 1 and groups == o:
        # depthwise: one product per tap and channel, summed in int32
        wk = w.reshape(o, k * k).to(torch.int32)
        acc = taps[0].to(torch.int32) * wk[:, 0, None, None]
        for t in range(1, k * k):
            acc = acc + taps[t].to(torch.int32) * wk[:, t, None, None]
        return acc
    # im2col rows (b, y, x), columns (channel, tap) as the OIHW kernel
    cols = torch.stack(taps, dim=-1).permute(0, 2, 3, 1, 4) \
        .reshape(b * ho * wo, c, k * k)
    og = o // groups
    outs = [int8_matmul(
        cols[:, gi * cg:(gi + 1) * cg].reshape(-1, cg * k * k),
        w[gi * og:(gi + 1) * og].reshape(og, cg * k * k))
        for gi in range(groups)]
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return acc.reshape(b, ho, wo, o).permute(0, 3, 1, 2)


def dequantize(acc: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """f32(acc) · scale + bias per output channel, rounded once: the f32
    product of two f32 values is exact in f64, so this is the fused
    multiply-add XLA makes of ``acc * (a_scale * w_scale) + b``."""
    prod = acc.float().double() * scale.double()[:, None, None]
    return (prod + bias.double()[:, None, None]).float()


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scale max(max|x|, 1e-12) / 127, a device scalar. The
    divisor is a tensor on x's device: divided by a Python number, the
    card multiplies by its float32 reciprocal where the CPU divides, and
    the two scales would differ in the last bit."""
    return torch.clamp(x.abs().amax(), min=1e-12) \
        / torch.full((), 127.0, device=x.device)


# ``conv_i8``'s activations (quant.py:96-101); False / None is none
_ACTS = {"silu": F.silu, "relu": F.relu, "gelu": gelu}


class QConv(nn.Module):
    """The int8 counterpart of ``Conv`` (``conv_i8``, quant.py:66)."""

    def __init__(self, conv: Conv):
        super().__init__()
        wf = conv.weight.detach().float()
        scale = torch.clamp(wf.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
        self.register_buffer("w_i8", torch.clamp(
            torch.round(wf / scale[:, None, None, None]), -127, 127)
            .to(torch.int8))
        self.register_buffer("w_scale", scale)
        self.register_buffer("bias", conv.bias.detach().float().clone())
        self.register_buffer("a_scale", None)
        self.stride, self.pad, self.act = conv.stride, conv.pad, conv.act
        self.observing = False
        self.running: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        dyn = None
        if self.a_scale is None or self.observing:
            dyn = dynamic_scale(xf)
        if self.observing:
            self.running = dyn if self.running is None \
                else torch.maximum(self.running, dyn)
        a = self.a_scale if self.a_scale is not None else dyn
        x_i8 = torch.clamp(torch.round(xf / a), -127, 127).to(torch.int8)
        acc = int8_conv(x_i8, self.w_i8, self.stride, self.pad)
        out = dequantize(acc, a * self.w_scale, self.bias)
        act = _ACTS.get("silu" if self.act is True else self.act)
        # the activation of the f32 value, evaluated in f64 and rounded
        # once: the correctly rounded result on the card and on the CPU
        # alike, so the two devices quantise the next layer's input the
        # same way
        return act(out.double()).float() if act is not None else out


def quantize_model_(model: nn.Module) -> nn.Module:
    """Replace every ``Conv`` of ``model`` by a :class:`QConv`, in place
    (``quantize_params``: only the convolutions; the transposed
    convolution and the classifier's linear layer stay f32)."""
    for name, child in list(model.named_children()):
        if isinstance(child, Conv):
            setattr(model, name, QConv(child))
        else:
            quantize_model_(child)
    return model


def qconvs(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, QConv)]


def observe(model: nn.Module) -> None:
    """Start (or restart) calibration: forwards fold each conv's dynamic
    scale into its running abs-max; calibrated convs keep computing with
    their static scale meanwhile, as ``capture_scales`` does."""
    for m in qconvs(model):
        m.observing, m.running = True, None


def finish_calibration(model: nn.Module) -> int:
    """Bake every observed running abs-max as the conv's static
    ``a_scale``; returns the number of convs calibrated."""
    convs = qconvs(model)
    if not convs or any(m.running is None for m in convs):
        raise RuntimeError("no calibration forward ran over every "
                           "quantized conv (call observe, then forward)")
    for m in convs:
        m.a_scale, m.observing, m.running = m.running.reshape(()), False, None
    return len(convs)


def has_static_scales(model: nn.Module) -> bool:
    convs = qconvs(model)
    return bool(convs) and all(m.a_scale is not None for m in convs)


def clear_static_scales(model: nn.Module) -> None:
    """Back to dynamic activation scales."""
    for m in qconvs(model):
        m.a_scale = None
