"""Device-side synthetic road source — the port of
``roadvision_tpu/io_video/synthetic_device.py``.

Renders the procedural road scene of
:class:`roadvision_tpu_torch.io_video.capture.SyntheticRoadSource` on the
device with tensor ops, so a benchmark loop can run with its frames
resident there: no host decode and no per-batch upload.

The static background is rendered once on the host and uploaded a single
time; the vehicles' rectangles are painted per frame with vectorised
masks from the frame index, by the host renderer's geometry formulas in
float32 (a rectangle edge may differ from the host's float64 result by a
pixel row or column).
"""
from __future__ import annotations

import torch

from ..utils.device import DeviceLike, resolve_device
from .capture import SyntheticRoadSource


class DeviceSyntheticSource:
    """``device`` defaults to the card; ``device="cpu"`` renders with the
    same tensor ops on the CPU."""

    def __init__(self, width: int = 640, height: int = 480,
                 num_vehicles: int = 4, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.host = SyntheticRoadSource(width, height, num_vehicles,
                                        seed=seed)
        self.w, self.h = int(width), int(height)
        self.n_veh = int(num_vehicles)
        self.seed = int(seed)
        self.bg = torch.from_numpy(self.host._background()).to(self.device)
        self.palette = torch.from_numpy(
            SyntheticRoadSource._PALETTE.copy()).to(self.device)
        self._shield = torch.tensor([210, 220, 225], dtype=torch.uint8,
                                    device=self.device)
        self._yy = torch.arange(self.h, dtype=torch.float32,
                                device=self.device)[None, :, None]
        self._xx = torch.arange(self.w, dtype=torch.float32,
                                device=self.device)[None, None, :]

    def make_render_fn(self, batch: int):
        """fn: first frame index (int) → (batch, H, W, 3) uint8."""
        steps = torch.arange(batch, device=self.device)

        def render(idx0):
            return self.render_at(int(idx0) + steps)

        return render

    def make_render_at_fn(self):
        """fn: (B,) integer frame indices → (B, H, W, 3) uint8, for
        arbitrary index schedules (repeated or slowed frames)."""
        return self.render_at

    @torch.inference_mode()
    def render_at(self, idxs) -> torch.Tensor:
        h, w, n_veh = self.h, self.w, self.n_veh
        horizon = 0.40 * h
        idx = torch.as_tensor(idxs, device=self.device).to(torch.float32)
        b = idx.shape[0]
        img = self.bg[None].expand(b, h, w, 3).clone()
        yy, xx = self._yy, self._xx

        def col(v):          # (B,) → (B, 1, 1) against the pixel grids
            return v[:, None, None]

        for v in range(n_veh):
            speed = 0.006 + 0.003 * ((v * 7 + self.seed) % 5)
            prog = ((idx * speed) + v / max(1, n_veh)) % 1.0
            yc = horizon + prog * (h - horizon) * 0.95
            scale = 0.25 + 0.75 * prog
            bw = 0.11 * w * scale
            bh = 0.09 * h * scale
            lane = -1.0 if v % 2 == 0 else 1.0
            xc = w / 2 + lane * (0.12 + 0.10 * prog) * w \
                + 0.02 * w * torch.sin(idx * 0.05 + v)
            x1 = torch.clamp(xc - bw / 2, min=0.0)
            y1 = torch.clamp(yc - bh, min=0.0)
            x2 = torch.clamp(xc + bw / 2, max=w - 1.0)
            y2 = torch.clamp(yc, max=h - 1.0)
            # integer-cast bounds like the host painter
            xi1, yi1, xi2, yi2 = (torch.floor(t) for t in (x1, y1, x2, y2))
            visible = col((x2 > 0) & (x1 < w) & (y2 > horizon * 0.5))
            body = (yy >= col(yi1)) & (yy < col(yi2)) \
                & (xx >= col(xi1)) & (xx < col(xi2)) & visible
            img = torch.where(body[..., None],
                              self.palette[v % len(self.palette)], img)
            wy = yi1 + torch.clamp(torch.floor((yi2 - yi1) / 5), min=1.0)
            inset = torch.floor((xi2 - xi1) / 6)
            shield = (yy >= col(yi1)) & (yy < col(wy)) \
                & (xx >= col(xi1 + inset)) & (xx < col(xi2 - inset)) & visible
            img = torch.where(shield[..., None], self._shield, img)
        return img
