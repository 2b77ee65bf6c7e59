"""Global (camera) motion compensation for the trackers — a copy of
``roadvision_tpu/track/gmc.py`` on tensors.

``tracking.gmc: true`` estimates the camera's translation between
consecutive frames by phase correlation of two G×G gray thumbnails
(strided mean, zero-padded), and the tracker step moves its position
memory by it before the association. The peak of
``irfft2(F₂·conj(F₁) / |F₂·conj(F₁)|)`` is taken at its first flat
index, wrapped to a signed shift and clamped to ±G·MAX_SHIFT_FRAC
thumbnail pixels.
"""
from __future__ import annotations

from typing import Sequence

import torch

GMC_SIZE = 128          # gray thumbnail side
MAX_SHIFT_FRAC = 0.25   # clamp |shift| to this fraction of the thumbnail


def gray_thumbnail(frame_u8: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 BGR → (..., G, G) f32 gray thumbnail (any
    leading batch and stream axes): the channel mean, then the mean of
    each (h // G) × (w // G) block; a frame smaller than G along an axis
    is zero-padded."""
    h, w = frame_u8.shape[-3:-1]
    sy = max(1, h // GMC_SIZE)
    sx = max(1, w // GMC_SIZE)
    gh = min(GMC_SIZE, h // sy)
    gw = min(GMC_SIZE, w // sx)
    crop = frame_u8[..., : sy * gh, : sx * gw, :]
    g = crop.to(torch.float32).mean(dim=-1)
    g = g.reshape(*g.shape[:-2], gh, sy, gw, sx).mean(dim=(-3, -1))
    return torch.nn.functional.pad(g, (0, GMC_SIZE - gw, 0, GMC_SIZE - gh))


def correlation_surface(prev_g: torch.Tensor,
                        cur_g: torch.Tensor) -> torch.Tensor:
    """([B,] G, G) pairs → ([B,] G, G) normalised phase-correlation
    surface (DC removed first)."""
    g = prev_g.shape[-1]
    f1 = torch.fft.rfft2(prev_g - prev_g.mean(dim=(-2, -1), keepdim=True))
    f2 = torch.fft.rfft2(cur_g - cur_g.mean(dim=(-2, -1), keepdim=True))
    cross = f2 * torch.conj(f1)
    return torch.fft.irfft2(cross / torch.clamp(cross.abs(), min=1e-9),
                            s=(g, g))


def phase_shift(prev_g: torch.Tensor, cur_g: torch.Tensor) -> torch.Tensor:
    """([B,] G, G) × ([B,] G, G) → ([B,] 2) f32 (dx, dy): the translation
    that maps ``prev`` content onto ``cur`` (thumbnail px, signed)."""
    g = prev_g.shape[-1]
    r = correlation_surface(prev_g, cur_g)
    idx = r.flatten(-2).argmax(dim=-1)
    dy = idx // g
    dx = idx % g
    dx = torch.where(dx > g // 2, dx - g, dx).to(torch.float32)
    dy = torch.where(dy > g // 2, dy - g, dy).to(torch.float32)
    lim = g * MAX_SHIFT_FRAC
    return torch.stack([dx.clamp(-lim, lim), dy.clamp(-lim, lim)], dim=-1)


def fresh_carry(lead: Sequence[int], device=None):
    """GMC's carry before the first batch: the thumbnails (*lead, G, G)
    (``lead`` (S,) for a fleet, () for one stream) and their flag (), 0:
    no previous batch."""
    return (torch.zeros((*lead, GMC_SIZE, GMC_SIZE), device=device),
            torch.zeros((), device=device))


def batch_shifts(prev_gray: torch.Tensor, grays: torch.Tensor,
                 prev_valid: torch.Tensor,
                 scale_xy: Sequence[float]) -> torch.Tensor:
    """Per-frame camera shifts of a batch in SOURCE pixels: prev_gray
    (..., G, G) the carried thumbnail of the previous batch's last frame,
    grays (..., B, G, G), prev_valid () 0.0 on the very first batch (the
    first shift forced to 0; one flag for every leading stream, as JAX's
    fleet shares it), scale_xy the thumbnail → source factors. Returns
    (..., B, 2) f32. The factors are numbers in the arithmetic, so a
    captured step uploads nothing."""
    prevs = torch.cat([prev_gray[..., None, :, :], grays[..., :-1, :, :]],
                      dim=-3)
    shifts = phase_shift(prevs, grays)
    first_w = torch.cat([prev_valid.reshape(1).to(torch.float32),
                         torch.ones((grays.shape[-3] - 1,),
                                    device=grays.device)])
    shifts = shifts * first_w[:, None]
    sx, sy = (float(v) for v in scale_xy)
    return torch.stack([shifts[..., 0] * sx, shifts[..., 1] * sy], dim=-1)
