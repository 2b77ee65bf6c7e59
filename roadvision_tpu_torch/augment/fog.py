"""Atmospheric-scattering fog synthesis — the port of
``roadvision_tpu/augment/fog.py``.

I = J·t + A·(1−t), t = exp(−β·d), with the same effect stack: a
multi-octave value-noise β field, a horizon / vanishing-point depth
proxy with sigmoid sky/road blending, an adaptive airlight from the top
band's bright pixels smoothed by a guided filter, edge-guided
transmission, a global veil, soft glow, a 3-band depth blur, a local
contrast fade on YCrCb luma, and random tint / gamma / sensor noise.
Presets light / medium / heavy, or β = 3.912 / MOR (Koschmieder).

:func:`rand_perlin` and :func:`_value_noise_octave` are the JAX module's
numpy code, copied: the same seed gives the same noise bit for bit. The
filters (:func:`box_mean` as integral-image box sums, :func:`guided_filter`,
the separable :func:`gaussian_blur` with reflect-101 borders) are torch
ops on the synthesizer's ``device``. :class:`EnhancedFogSynthesizer`
draws from its ``RandomState`` in the JAX class's order, so a seed gives
the same fog parameters; it computes in float64 (the JAX class in
float32), so the card and the CPU give the same bytes, and the output
stays within 2 u8 levels of the JAX synthesizer's in ≤ 0.1 % of the
pixels (tests/test_torch_fog.py).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.color import (bgr_planes_to_ycrcb_i32, bgr_to_gray_u8,
                         ycrcb_planes_to_bgr_i32)
from ..utils.device import DeviceLike, resolve_device

FOG_PRESETS = {
    "light": dict(beta=(0.03, 0.06), airlight=(0.82, 0.93),
                  glow=(0.12, 0.22), contrast_drop=(0.06, 0.12)),
    "medium": dict(beta=(0.06, 0.12), airlight=(0.86, 0.96),
                   glow=(0.18, 0.34), contrast_drop=(0.10, 0.18)),
    "heavy": dict(beta=(0.12, 0.22), airlight=(0.90, 0.99),
                  glow=(0.28, 0.48), contrast_drop=(0.15, 0.26)),
}

# the reference fog tool's constructor overrides (global_veil 0.5 against
# the synthesizer's 0.06), shared by tools/fog_batch.py and the fogged
# synthetic source, as in the JAX package
CLI_OVERRIDES = dict(
    y_h_ratio=0.42,
    perlin_scale_ratio=0.18,
    perlin_octaves=2,
    horizon_softness=0.07,
    global_veil=0.5,
    depth_blur_max=4.0,
)


def _value_noise_octave(rng, out_hw, lattice_hw) -> np.ndarray:
    """One octave: a coarse uniform-random lattice bilinearly resampled.

    Rows are lerped first, then columns, with the a+(b-a)*t form; lattice
    samples are drawn once per octave from ``rng``.
    """
    h, w = out_hw
    gh, gw = lattice_hw
    lattice = rng.rand(gh + 1, gw + 1).astype(np.float32)
    yy = np.linspace(0.0, gh, h, endpoint=False)
    xx = np.linspace(0.0, gw, w, endpoint=False)
    yi = yy.astype(np.intp)
    xi = xx.astype(np.intp)
    fy = (yy - yi).astype(np.float32)[:, None]
    fx = (xx - xi).astype(np.float32)[None, :]

    def lerp_cols(rows: np.ndarray) -> np.ndarray:
        left = rows[:, xi]
        return left + (rows[:, np.minimum(xi + 1, gw)] - left) * fx

    upper = lerp_cols(lattice[yi])
    lower = lerp_cols(lattice[np.minimum(yi + 1, gh)])
    return upper + (lower - upper) * fy


def rand_perlin(h: int, w: int, scale: int = 128, octaves: int = 2,
                persistence: float = 0.5, lacunarity: float = 2.0,
                seed: Optional[int] = None) -> np.ndarray:
    """Multi-octave bilinear value noise in [0, 1].

    Octave o uses a lattice of ~(h, w)·lacunarity^o / scale cells and
    weight persistence^o; the weighted sum is min-max normalized.
    """
    rng = np.random.RandomState(seed) if seed is not None else np.random
    fields, weights = [], []
    cell_density = 1.0 / max(1, scale)
    for octave in range(max(1, octaves)):
        lattice_hw = (max(1, int(h * cell_density)),
                      max(1, int(w * cell_density)))
        fields.append(_value_noise_octave(rng, (h, w), lattice_hw))
        weights.append(persistence ** octave)
        cell_density *= lacunarity
    mixed = sum(wt * f for wt, f in zip(weights, fields))
    mixed /= max(1e-6, sum(weights))
    lo, hi = float(mixed.min()), float(mixed.max())
    return ((mixed - lo) / max(1e-6, hi - lo)).astype(np.float32)


# ---------------------------------------------------------------------------
# filtering primitives (torch)
# ---------------------------------------------------------------------------

def _box_sum(v: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    """Sliding-window sum over [i-r, i+r] ∩ [0, n) along ``dim`` (cumsum)."""
    n = v.shape[dim]
    c = torch.cumsum(v, dim=dim)
    ar = torch.arange(n, device=v.device)
    upper = c.index_select(dim, (ar + radius).clamp(0, n - 1))
    lo = ar - radius - 1
    lower = c.index_select(dim, lo.clamp(0, n - 1))
    shape = [1] * v.dim()
    shape[dim] = n
    return upper - torch.where((lo >= 0).reshape(shape), lower,
                               torch.zeros_like(lower))


def box_mean(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Normalized box filter with edge-correct counts (integral images),
    over the first two dims of an (H, W) or (H, W, C) tensor."""
    if x.dim() == 3:
        return torch.stack([box_mean(x[..., c], radius)
                            for c in range(x.shape[-1])], dim=-1)
    num = _box_sum(_box_sum(x, radius, 0), radius, 1)
    den = _box_sum(_box_sum(torch.ones_like(x), radius, 0), radius, 1)
    return num / den


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int = 8,
                  eps: float = 1e-3) -> torch.Tensor:
    """Edge-preserving guided filter (He et al.) as box-filter algebra;
    guide, src (H, W) float32 in [0, 1]."""
    mean_i = box_mean(guide, radius)
    mean_p = box_mean(src, radius)
    corr_ip = box_mean(guide * src, radius)
    corr_ii = box_mean(guide * guide, radius)
    var_i = corr_ii - mean_i * mean_i
    cov_ip = corr_ip - mean_i * mean_p
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return box_mean(a, radius) * guide + box_mean(b, radius)


def _reflect101(v: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Pad ``dim`` by ``r`` on both sides, mirrored without repeating the
    edge (numpy's "reflect", OpenCV's BORDER_REFLECT_101)."""
    n = v.shape[dim]
    idx = torch.arange(-r, n + r, device=v.device)
    period = 2 * (n - 1) if n > 1 else 1
    idx = idx.remainder(period)
    idx = torch.where(idx >= n, period - idx, idx)
    return v.index_select(dim, idx)


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian over the first two dims, reflect-101 border
    (cv2.GaussianBlur parity)."""
    ksize = int(ksize) | 1
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = ksize // 2
    t = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(t * t) / (2 * sigma * sigma))
    k = torch.from_numpy(k / k.sum()).to(device=x.device, dtype=x.dtype)

    def conv_axis(v, dim):
        vp = _reflect101(v, r, dim)
        n = v.shape[dim]
        out = torch.zeros_like(v)
        for j in range(ksize):
            out = out + k[j] * vp.narrow(dim, j, n)
        return out

    return conv_axis(conv_axis(x, 0), 1)


def _ensure_3c(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() == 3 else torch.stack([x, x, x], dim=-1)


def _rand_range(lo, hi, rng) -> float:
    return float(lo + (hi - lo) * rng.rand())


def _u8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] float → uint8, rounding half up (clip(x·255 + 0.5))."""
    return (x * 255 + 0.5).clamp(0, 255).to(torch.uint8)


# the synthesizer's working precision: float64, rounded to uint8 once at
# each of the reference's conversions, so that the card and the CPU give
# the same bytes (in float32 their sums and transcendental functions
# differ in the last bits, which a .5 boundary of a u8 rounding turns
# into whole levels); the JAX synthesizer's float32 stays within the
# bound its tests state
_F = torch.float64


class EnhancedFogSynthesizer:
    """Road fog synthesis with the reference's parameters; the filters run
    on ``device`` (the card unless "cpu" is asked for)."""

    def __init__(self, level: str = "medium", mor: Optional[float] = None,
                 y_h_ratio: float = 0.42, vanishing_x_ratio: float = 0.5,
                 perlin_scale_ratio: float = 0.18, perlin_octaves: int = 2,
                 sky_boost: float = 1.25, road_damp: float = 0.9,
                 edge_guided: bool = True, horizon_softness: float = 0.06,
                 depth_blur_max: float = 3.5, global_veil: float = 0.06,
                 seed: Optional[int] = None, device: DeviceLike = None):
        self.level = level
        self.mor = mor
        self.y_h_ratio = y_h_ratio
        self.vx_ratio = vanishing_x_ratio
        self.perlin_scale_ratio = perlin_scale_ratio
        self.perlin_octaves = perlin_octaves
        self.sky_boost = sky_boost
        self.road_damp = road_damp
        self.edge_guided = edge_guided
        self.horizon_softness = horizon_softness
        self.depth_blur_max = depth_blur_max
        self.global_veil = global_veil
        self.rng = np.random.RandomState(seed) if seed is not None else np.random
        self.device = resolve_device(device)

    def _t(self, a) -> torch.Tensor:
        """A host value as a float64 tensor on the device."""
        return torch.as_tensor(np.asarray(a), dtype=_F, device=self.device)

    # -- adaptive airlight --
    def _airlight(self, img: torch.Tensor) -> torch.Tensor:
        h, w = img.shape[:2]
        band_h = max(10, int(0.12 * h))
        top = img[:band_h].cpu().numpy()
        lum = 0.299 * top[:, :, 2] + 0.587 * top[:, :, 1] + 0.114 * top[:, :, 0]
        thr = np.quantile(lum, 0.9)
        mask = lum >= thr
        if mask.sum() < 100:
            a_rgb = top.mean(axis=(0, 1))
        else:
            a_rgb = top[mask].mean(axis=0)
        tint = self.rng.uniform(-0.02, 0.02, size=3).astype(np.float32)
        a_rgb = np.clip(a_rgb + tint, 0.7, 1.0).astype(np.float32)
        dev = self.device
        vgrad = torch.linspace(1.0, 0.85, h, dtype=_F, device=dev)[:, None]
        xgrad = torch.linspace(0.95, 1.05, w, dtype=_F, device=dev)[None, :]
        a_map = _ensure_3c(vgrad * xgrad) * self._t(a_rgb)[None, None, :]
        guide = img.mean(dim=2)
        chans = [guided_filter(guide, a_map[:, :, c], radius=16, eps=1e-3)
                 for c in range(3)]
        return torch.stack(chans, dim=-1).clamp(0.7, 1.0)

    # -- depth prior --
    def _depth_proxy(self, h: int, w: int):
        y_h = int(self.y_h_ratio * h)
        dev = self.device
        yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing="ij")
        yy = yy.to(_F)
        xx = xx.to(_F)
        d_persp = 1.0 / (yy - y_h).clamp(min=1.0)
        vx, vy = float(self.vx_ratio * w), float(y_h)
        r = torch.sqrt((xx - vx) ** 2 + (yy - vy) ** 2) + 1.0
        d_vanish = 1.0 / r
        d = 0.7 * (d_persp / d_persp.max()) + 0.3 * (d_vanish / d_vanish.max())
        d = (d - d.min()) / (d.max() - d.min()).clamp(min=1e-6)
        softness = max(1e-3, self.horizon_softness) * h
        sky_weight = torch.sigmoid((y_h - yy) / softness)
        d = d * (1.0 + (self.sky_boost - 1.0) * sky_weight) \
            * torch.pow(torch.tensor(self.road_damp, dtype=_F, device=dev),
                        1.0 - sky_weight)
        return d.clamp(0, 1), y_h, sky_weight

    def _beta_map(self, h: int, w: int, base_beta: float) -> torch.Tensor:
        scale = max(16, int(self.perlin_scale_ratio * w))
        noise = rand_perlin(h, w, scale=scale, octaves=self.perlin_octaves,
                            seed=int(self.rng.randint(int(1e9))))
        return self._t(base_beta * (0.85 + 0.35 * noise))

    def _transmission(self, beta_map, depth, guide):
        t = torch.exp(-beta_map * depth).clamp(0.05, 1.0)
        if self.edge_guided:
            t = guided_filter(guide, t, radius=8, eps=1e-3).clamp(0.05, 1.0)
        return t

    # -- soft glow --
    def _glow(self, img: torch.Tensor, strength: float) -> torch.Tensor:
        gray = bgr_to_gray_u8(_u8(img)).to(_F) / 255.0
        thr = (gray.mean() + 0.6 * gray.std(correction=0)).clamp(0.65, 0.9)
        hard = (gray > thr).to(_F)
        k = int(9 + 20 * strength) | 1
        soft = gaussian_blur(hard, k, k * 0.35).clamp(0, 1)
        k2 = int(max(7, (img.shape[0] + img.shape[1])
                     * (0.003 + 0.01 * strength))) | 1
        blur = gaussian_blur(img, k2, k2 * 0.25)
        soft3 = soft[..., None]
        return (img * (1 - soft3) + (img + strength * blur) * soft3).clamp(0, 1)

    # -- 3-band depth blur --
    def _depth_blur(self, hazy, depth, strength: float):
        r = (depth * self.depth_blur_max * (0.5 + strength)) \
            .clamp(0.0, self.depth_blur_max * 1.5)
        out = hazy
        prev = 0.0
        for band in (0.33, 0.66, 1.0):
            mask = ((depth >= prev) & (depth < band)).to(_F)
            prev = band
            count = float(mask.sum())
            if count < 100:
                continue
            rad = int(max(1, float((r * mask).sum() / count) * 1.5)) | 1
            if rad <= 1:
                continue
            blurred = gaussian_blur(hazy, rad, rad * 0.5)
            m3 = _ensure_3c(gaussian_blur(mask, rad | 1, rad * 0.5))
            out = out * (1 - m3) + blurred * m3
        return out.clamp(0, 1)

    # -- local contrast fade --
    def _contrast_fade(self, img, amount: float):
        u8 = _u8(img)
        y, cr, cb = bgr_planes_to_ycrcb_i32(u8[..., 0], u8[..., 1],
                                            u8[..., 2])
        yf = y.to(_F) / 255.0
        # an edge-preserving smooth of luma (the guided filter in the
        # bilateral filter's role: keep edges, kill local contrast)
        rad = (int(5 + amount * 20) | 1) // 2
        y_smooth = guided_filter(yf, yf, radius=max(2, rad), eps=1e-2)
        y_mix = ((1.0 - amount) * yf + amount * y_smooth).clamp(0, 1)
        y_u8 = torch.round(y_mix * 255).clamp(0, 255).to(torch.uint8)
        b, g, r = ycrcb_planes_to_bgr_i32(y_u8, cr, cb)
        return torch.stack([b, g, r], dim=-1).to(_F) / 255.0

    # -- main entry --
    def synthesize(self, bgr_uint8: np.ndarray,
                   level: Optional[str] = None
                   ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """(H, W, 3) BGR uint8 → (fogged BGR uint8, {beta_map, A_map,
        depth, y_h, t})."""
        src = torch.from_numpy(np.ascontiguousarray(bgr_uint8)) \
            .to(self.device)
        img = src.to(_F) / 255.0
        h, w = img.shape[:2]
        if level is not None:
            self.level = level

        if self.mor is not None and self.mor > 0:
            base_beta = 3.912 / float(self.mor)  # Koschmieder
            glow_rng = (0.12, 0.45)
            cdrop_rng = (0.08, 0.22)
            a_rng = (0.86, 0.98)
        else:
            preset = FOG_PRESETS[self.level]
            base_beta = _rand_range(*preset["beta"], self.rng)
            glow_rng = preset["glow"]
            cdrop_rng = preset["contrast_drop"]
            a_rng = preset["airlight"]

        depth, y_h, sky_weight = self._depth_proxy(h, w)
        beta_map = self._beta_map(h, w, base_beta)

        a_map = self._airlight(img)
        scale = _rand_range(*a_rng, self.rng) / max(1e-6, float(a_map.mean()))
        a_map = (a_map * scale).clamp(0.75, 1.0)

        guide = bgr_to_gray_u8(src).to(_F) / 255.0
        t = self._transmission(beta_map, depth, guide)
        t3 = _ensure_3c(t)

        hazy = img * t3 + a_map * (1.0 - t3)

        gv3 = _ensure_3c(self.global_veil * (0.6 + 0.4 * sky_weight))
        hazy = (hazy * (1.0 - gv3) + a_map * gv3).clamp(0, 1)

        hazy = self._glow(hazy, _rand_range(*glow_rng, self.rng))
        hazy = self._depth_blur(hazy, depth, strength=base_beta)
        hazy = self._contrast_fade(hazy, _rand_range(*cdrop_rng, self.rng))

        tint = (1.0 + self.rng.uniform(-0.015, 0.02, size=3)).astype(np.float32)
        hazy = (hazy * self._t(tint)[None, None, :]).clamp(0, 1)
        if self.rng.rand() < 0.35:
            gamma = 1.0 + self.rng.uniform(-0.04, 0.05)
            hazy = (hazy ** gamma).clamp(0, 1)
        if self.rng.rand() < 0.3:
            noise = self.rng.normal(0, 0.0035, size=hazy.shape) \
                .astype(np.float32)
            hazy = (hazy + self._t(noise)).clamp(0, 1)

        out = _u8(hazy).cpu().numpy()

        def host(v):
            return v.to(torch.float32).cpu().numpy()
        return out, {"beta_map": host(beta_map), "A_map": host(a_map),
                     "depth": host(depth), "y_h": y_h, "t": host(t)}
