"""The preprocess chain, plain: BGR → YCrCb in OpenCV's 14-bit fixed
point, CLAHE on the luma (OpenCV's algorithm: per-tile histograms, clip
and redistribution, LUTs, the bilinear blend of four tile LUTs with each
product and sum rounded alone), back to BGR, then a 3×3 median of each
channel with a replicated border. Integer and float32 torch ops."""
from __future__ import annotations

import numpy as np
import torch

# OpenCV's BT.601 coefficients, 14-bit fixed point
SHIFT = 14
R2Y, G2Y, B2Y = 4899, 9617, 1868
CR_COEF, CB_COEF = 11682, 9241
CR2R, CR2G, CB2G, CB2B = 22987, -11698, -5636, 29049


def _descale(x: torch.Tensor) -> torch.Tensor:
    return (x + (1 << (SHIFT - 1))) >> SHIFT


def bgr_to_ycrcb(b, g, r):
    b, g, r = (t.to(torch.int32) for t in (b, g, r))
    y = _descale(r * R2Y + g * G2Y + b * B2Y)
    cr = _descale((r - y) * CR_COEF + (128 << SHIFT)).clamp(0, 255)
    cb = _descale((b - y) * CB_COEF + (128 << SHIFT)).clamp(0, 255)
    return y, cr, cb


def ycrcb_to_bgr(y, cr, cb):
    y, cr, cb = (t.to(torch.int32) for t in (y, cr, cb))
    r = (y + _descale((cr - 128) * CR2R)).clamp(0, 255)
    g = (y + _descale((cr - 128) * CR2G + (cb - 128) * CB2G)).clamp(0, 255)
    b = (y + _descale((cb - 128) * CB2B)).clamp(0, 255)
    return b, g, r


def _reflect101(n: int, pad: int) -> torch.Tensor:
    return torch.from_numpy(np.pad(np.arange(n), (0, pad), mode="reflect"))


def clahe(y: torch.Tensor, clip_limit: float, grid: int) -> torch.Tensor:
    """(N, H, W) values in [0, 255] → (N, H, W) int32, OpenCV's CLAHE."""
    n, h, w = y.shape
    dev = y.device
    if h % grid or w % grid:
        pad_h, pad_w = grid - h % grid, grid - w % grid
    else:
        pad_h = pad_w = 0
    ye = y.long()
    if pad_h or pad_w:
        ye = ye[:, _reflect101(h, pad_h).to(dev)][:, :, _reflect101(
            w, pad_w).to(dev)]
    th, tw = (h + pad_h) // grid, (w + pad_w) // grid
    area = th * tw
    tiles = ye.reshape(n, grid, th, grid, tw).permute(0, 1, 3, 2, 4) \
        .reshape(n * grid * grid, area)
    hist = torch.zeros((n * grid * grid, 256), dtype=torch.long, device=dev)
    hist.scatter_add_(1, tiles, torch.ones_like(tiles))
    clip = max(int(clip_limit * area / 256), 1) if clip_limit > 0 else 0
    if clip:
        excess = (hist - clip).clamp(min=0).sum(dim=1, keepdim=True)
        hist = hist.clamp(max=clip) + excess // 256
        residual = excess % 256
        step = (256 // residual.clamp(min=1)).clamp(min=1)
        bins = torch.arange(256, device=dev)[None]
        hist = hist + ((bins % step == 0) & (bins // step < residual)).long()
    scale = torch.tensor(255.0 / area, dtype=torch.float32, device=dev)
    lut = torch.round(hist.cumsum(dim=1).float() * scale).clamp(0, 255) \
        .long().reshape(n, grid, grid, 256)

    def axis(size, tile):
        pos = torch.arange(size, dtype=torch.float32, device=dev) \
            * torch.tensor(1.0 / tile, dtype=torch.float32, device=dev) - 0.5
        i1 = torch.floor(pos)
        frac = pos - i1
        return (i1.long().clamp(min=0), (i1.long() + 1).clamp(max=grid - 1),
                frac)

    ty1, ty2, ya = axis(h, th)
    tx1, tx2, xa = axis(w, tw)
    v = y.long()
    nn_ = torch.arange(n, device=dev)[:, None, None]

    def tap(ty, tx):
        return lut[nn_, ty[None, :, None], tx[None, None, :], v].float()

    xa, ya = xa[None, None, :], ya[None, :, None]
    top = tap(ty1, tx1) * (1.0 - xa) + tap(ty1, tx2) * xa
    bot = tap(ty2, tx1) * (1.0 - xa) + tap(ty2, tx2) * xa
    res = top * (1.0 - ya) + bot * ya
    return torch.round(res).clamp(0, 255).to(torch.int32)


def median3(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) → (N, H, W): the median of each 3×3 window, border
    replicated."""
    h, w = x.shape[-2:]
    xp = torch.nn.functional.pad(x[:, None].float(), (1, 1, 1, 1),
                                 mode="replicate")[:, 0]
    win = torch.stack([xp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                       for dx in range(3)])
    return win.median(dim=0).values.to(x.dtype)


def chain(frames: torch.Tensor, clip_limit: float, grid: int,
          ksize: int) -> torch.Tensor:
    """(N, H, W, 3) uint8 BGR → (N, H, W, 3) uint8: CLAHE on the YCrCb
    luma, then the median of each channel."""
    if ksize != 3:
        raise ValueError("the reference median is 3×3")
    b, g, r = (frames[..., c] for c in range(3))
    y, cr, cb = bgr_to_ycrcb(b, g, r)
    b, g, r = ycrcb_to_bgr(clahe(y, clip_limit, grid), cr, cb)
    return torch.stack([median3(c) for c in (b, g, r)], dim=-1) \
        .to(torch.uint8)
