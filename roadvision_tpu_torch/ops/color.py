"""OpenCV-exact fixed-point colour conversions on integer planes.

Port of ``roadvision_tpu/ops/color.py:39-98`` (``gray_from_bgr_planes``,
``bgr_planes_to_ycrcb_i32``, ``ycrcb_planes_to_bgr_i32``): BT.601
coefficients in 14-bit fixed point (15-bit for gray), descale
``(x + 2^(n-1)) >> n``, saturate to [0, 255]. Plain torch integer ops on
any device; the products widen to int32 and the result keeps the input
dtype (uint8 planes stay uint8). LAB waits for a later slice.
"""
from __future__ import annotations

import torch

_SHIFT = 14
_HALF = 1 << (_SHIFT - 1)
_R2Y, _G2Y, _B2Y = 4899, 9617, 1868
_GRAY_SHIFT = 15
_R2GRAY, _G2GRAY, _B2GRAY = 9798, 19235, 3735
_CR_COEF, _CB_COEF = 11682, 9241
_CR2R, _CR2G, _CB2G, _CB2B = 22987, -11698, -5636, 29049
_DELTA = 128 << _SHIFT


def _descale(x: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_right_shift(x + _HALF, _SHIFT)


def _i32(*planes):
    return tuple(p.to(torch.int32) for p in planes)


def gray_from_bgr_planes(b: torch.Tensor, g: torch.Tensor,
                         r: torch.Tensor) -> torch.Tensor:
    """Integer BGR planes → gray plane (OpenCV's 15-bit path)."""
    b32, g32, r32 = _i32(b, g, r)
    acc = r32 * _R2GRAY + g32 * _G2GRAY + b32 * _B2GRAY \
        + (1 << (_GRAY_SHIFT - 1))
    return torch.bitwise_right_shift(acc, _GRAY_SHIFT).to(b.dtype)


def bgr_planes_to_ycrcb_i32(b: torch.Tensor, g: torch.Tensor,
                            r: torch.Tensor):
    """Integer BGR planes → (y, cr, cb) planes, OpenCV-exact, saturated."""
    b32, g32, r32 = _i32(b, g, r)
    y = _descale(r32 * _R2Y + g32 * _G2Y + b32 * _B2Y)
    cr = _descale((r32 - y) * _CR_COEF + _DELTA).clamp_(0, 255)
    cb = _descale((b32 - y) * _CB_COEF + _DELTA).clamp_(0, 255)
    dt = b.dtype
    return y.to(dt), cr.to(dt), cb.to(dt)


def ycrcb_planes_to_bgr_i32(y: torch.Tensor, cr: torch.Tensor,
                            cb: torch.Tensor):
    """Integer YCrCb planes → (b, g, r) planes, OpenCV-exact, saturated."""
    y32, cr32, cb32 = _i32(y, cr, cb)
    crd = cr32 - 128
    cbd = cb32 - 128
    r = (y32 + _descale(crd * _CR2R)).clamp_(0, 255)
    g = (y32 + _descale(crd * _CR2G + cbd * _CB2G)).clamp_(0, 255)
    b = (y32 + _descale(cbd * _CB2B)).clamp_(0, 255)
    dt = y.dtype
    return b.to(dt), g.to(dt), r.to(dt)
