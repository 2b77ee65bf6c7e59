"""OpenCV-exact fixed-point colour conversions on integer planes.

Port of ``roadvision_tpu/ops/color.py:39-106`` (``gray_from_bgr_planes``,
``bgr_planes_to_ycrcb_i32``, ``ycrcb_planes_to_bgr_i32``,
``bgr_to_gray_u8``): BT.601 coefficients in 14-bit fixed point (15-bit
for gray), descale ``(x + 2^(n-1)) >> n``, saturate to [0, 255]. Plain
torch integer ops on any device; the products widen to int32 and the
result keeps the input dtype (uint8 planes stay uint8).

LAB (``color.py:138-221`` and ``:286-368``): OpenCV's integer u8
pipelines in both directions, ``bgr_to_lab_u8_fixed`` (RGB2Lab_b) and
``lab_to_bgr_u8_fixed`` (Lab2RGBinteger). The tables are built on the
host in numpy exactly as the JAX package builds them, float32 matrix
constants included, and gathered with integer indexing; everything else
is int32 arithmetic, so both are bit-equal to the JAX functions.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
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


def bgr_to_gray_u8(bgr: torch.Tensor) -> torch.Tensor:
    """(..., 3) BGR uint8 → GRAY uint8, OpenCV's bit-exact 15-bit path."""
    return gray_from_bgr_planes(bgr[..., 0], bgr[..., 1], bgr[..., 2]) \
        .to(torch.uint8)


# ---------------------------------------------------------------------------
# LAB, both directions in OpenCV's integer arithmetic

_LAB_SHIFT = 12           # xyz coefficient fixed point
_GAMMA_SHIFT = 3          # gamma table output scale (x8, max 2040)
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_LAB_CBRT_TAB_N = (255 * 3 // 2 + 1) * (1 << _GAMMA_SHIFT)
# OpenCV builds its cube-root table with a softfloat cbrt; a correctly
# rounded float64 cbrt differs at exactly these entries (color.py:144-153)
_LAB_CBRT_SOFTFLOAT_DELTAS = {49: -1, 628: 1}
_LAB_LSCALE = (116 * 255 + 50) // 100
_LAB_LSHIFT = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
# the matrices and the white point are float32 constants in the JAX
# package, widened to float64 when the tables are built
_XYZ_FROM_RGB = np.array([[0.412453, 0.357580, 0.180423],
                          [0.212671, 0.715160, 0.072169],
                          [0.019334, 0.119193, 0.950227]], np.float32)
_RGB_FROM_XYZ = np.array([[3.240479, -1.537150, -0.498535],
                          [-0.969256, 1.875991, 0.041556],
                          [0.055648, -0.204043, 1.057311]], np.float32)
_WHITE = np.array([0.950456, 1.0, 1.088754], np.float32)
_INV_BASE_SHIFT = 14
_INV_BASE = 1 << _INV_BASE_SHIFT
_INV_MINAB = -8145
_INV_GAMMA_N = 4096


@functools.lru_cache(maxsize=None)
def lab_tables():
    """(gamma u8 → linear x8, f(t) in 15-bit fixed point, 12-bit
    XYZ-over-white coefficients), as ``color.py::_build_lab_tables``."""
    i = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(i <= 0.04045, i / 12.92, ((i + 0.055) / 1.055) ** 2.4)
    gamma_tab = np.rint(lin * 255.0 * (1 << _GAMMA_SHIFT)).astype(np.int32)
    x = np.arange(_LAB_CBRT_TAB_N, dtype=np.float64) \
        / (255.0 * (1 << _GAMMA_SHIFT))
    f = np.where(x < 0.008856, x * 7.787 + 16.0 / 116.0, np.cbrt(x))
    cbrt_tab = np.rint(f * (1 << _LAB_SHIFT2)).astype(np.int32)
    for idx, d in _LAB_CBRT_SOFTFLOAT_DELTAS.items():
        cbrt_tab[idx] += d
    m = _XYZ_FROM_RGB.astype(np.float64)
    white = _WHITE.astype(np.float64)
    coeffs = np.rint(m / white[:, None] * (1 << _LAB_SHIFT)).astype(np.int64)
    if not (coeffs.sum(axis=1) == (1 << _LAB_SHIFT)).all():
        raise AssertionError("XYZ rows must sum to 1 << 12")
    return gamma_tab, cbrt_tab, coeffs


@functools.lru_cache(maxsize=None)
def lab_inv_tables():
    """(L → y, L → ify, f → t inverse, 12-bit XYZ → linear sRGB
    coefficients, inverse gamma), as ``color.py::_build_lab_inv_tables``."""
    li = np.arange(256, dtype=np.float64) * 100.0 / 255.0
    toe = li <= 0.008856 * 903.3
    y_toe = li / 903.3
    fy = (li + 16.0) / 116.0
    y_tab = np.where(toe, np.rint(_INV_BASE * y_toe),
                     np.rint(_INV_BASE * fy ** 3)).astype(np.int32)
    ify_tab = np.where(toe,
                       np.rint(_INV_BASE * (7.787 * y_toe + 16.0 / 116.0)),
                       np.rint(_INV_BASE * fy)).astype(np.int32)
    i = np.arange(_INV_MINAB, _INV_BASE * 9 // 4, dtype=np.int64)

    def ctrunc(a, d):              # C division: truncates toward zero
        q = np.abs(a) // d
        return np.where(a < 0, -q, q)

    lin = ctrunc(i * 108, 841) - 290
    cube = ctrunc(ctrunc(i * i, _INV_BASE) * i, _INV_BASE)
    ab_tab = np.where(i <= 3390, lin, cube).astype(np.int32)
    m = _RGB_FROM_XYZ.astype(np.float64)
    white = _WHITE.astype(np.float64)
    coeffs = np.rint(m * white[None, :] * (1 << 12)).astype(np.int64)
    t = np.arange(_INV_GAMMA_N, dtype=np.float64) / _INV_GAMMA_N
    g = np.where(t <= 0.0031308, t * 12.92,
                 1.055 * t ** (1.0 / 2.4) - 0.055)
    gamma_tab = np.rint(g * 255.0).astype(np.int32)
    return y_tab, ify_tab, ab_tab, coeffs, gamma_tab


_dev_lab: Dict[tuple, tuple] = {}


def _tables_on(device: torch.device, which: str):
    """The int32 lookup tables of one direction on ``device`` (cached)."""
    key = (str(device), which)
    got = _dev_lab.get(key)
    if got is None:
        if which == "fwd":
            arrays = lab_tables()[:2]
        else:
            y, ify, ab, _, gamma = lab_inv_tables()
            arrays = (y, ify, ab, gamma)
        got = tuple(torch.from_numpy(a).to(device) for a in arrays)
        _dev_lab[key] = got
    return got


def _descale_n(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bitwise_right_shift(x + (1 << (n - 1)), n)


def _sat_u8(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0, 255).to(torch.uint8)


def bgr_to_lab_u8_fixed(bgr: torch.Tensor) -> torch.Tensor:
    """(..., 3) BGR uint8 → LAB uint8 by OpenCV's integer RGB2Lab_b."""
    gamma, cbrt = _tables_on(bgr.device, "fwd")
    c = lab_tables()[2]
    x = bgr.long()
    b, g, r = gamma[x[..., 0]], gamma[x[..., 1]], gamma[x[..., 2]]

    def fchan(row):
        idx = _descale_n(r * int(c[row, 0]) + g * int(c[row, 1])
                         + b * int(c[row, 2]), _LAB_SHIFT)
        return cbrt[idx.clamp_(0, _LAB_CBRT_TAB_N - 1).long()]

    fx, fy, fz = fchan(0), fchan(1), fchan(2)
    l_ = _descale_n(_LAB_LSCALE * fy + _LAB_LSHIFT, _LAB_SHIFT2)
    a_ = _descale_n(500 * (fx - fy) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    b_ = _descale_n(200 * (fy - fz) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    return torch.stack([_sat_u8(l_), _sat_u8(a_), _sat_u8(b_)], dim=-1)


def lab_to_bgr_u8_fixed(lab: torch.Tensor) -> torch.Tensor:
    """(..., 3) LAB uint8 → BGR uint8 by OpenCV's Lab2RGBinteger."""
    y_tab, ify_tab, ab_tab, gamma = _tables_on(lab.device, "inv")
    c = lab_inv_tables()[3]
    x = lab.long()
    ll, aa, bb = x[..., 0], x[..., 1], x[..., 2]
    yy, ify = y_tab[ll], ify_tab[ll]
    aa, bb = aa.to(torch.int32), bb.to(torch.int32)
    adiv = torch.bitwise_right_shift(5 * aa * 53687 + (1 << 7), 13) \
        - 128 * _INV_BASE // 500
    bdiv = torch.bitwise_right_shift(bb * 41943 + (1 << 4), 9) \
        - 128 * _INV_BASE // 200 + 1
    nmax = ab_tab.shape[0] - 1
    xx = ab_tab[(ify + adiv - _INV_MINAB).clamp_(0, nmax).long()]
    zz = ab_tab[(ify - bdiv - _INV_MINAB).clamp_(0, nmax).long()]

    def chan(row):
        v = torch.bitwise_right_shift(
            int(c[row, 0]) * xx + int(c[row, 1]) * yy + int(c[row, 2]) * zz
            + (1 << 13), 14)
        return gamma[v.clamp_(0, _INV_GAMMA_N - 1).long()]

    r, g, b = chan(0), chan(1), chan(2)
    return torch.stack([_sat_u8(b), _sat_u8(g), _sat_u8(r)], dim=-1)
