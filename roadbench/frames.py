"""The benchmark's camera frames: a frozen copy of the procedural road
scene that ``roadvision_tpu_torch/io_video/synthetic_device.py``
(``DeviceSyntheticSource``) renders on the device, with the host
background and palette of ``io_video/capture.py::SyntheticRoadSource``.

Kept here so that the inputs cannot change under a later change of the
program: the scene, its vehicles' paths and colours are the yardstick's.
A test holds it bit-equal to ``DeviceSyntheticSource`` on the CPU.

:func:`camera_pool` renders every camera's clip at set-up, on the
device: camera i gets its own scene seed (speeds) and start frame
(phase), both drawn from the run's seed.
"""
from __future__ import annotations

import numpy as np
import torch

PALETTE = np.array([
    (48, 48, 200), (200, 48, 48), (48, 180, 48), (32, 160, 220),
    (160, 64, 160), (64, 200, 200), (220, 160, 32), (96, 96, 96),
], dtype=np.uint8)
SHIELD = (210, 220, 225)
# the scene's seed only picks each vehicle's speed, (v * 7 + seed) % 5,
# so the work of a frame does not depend on it; start frames stay below
# this so the float32 frame index keeps its fraction
MAX_START = 1000
RENDER_CHUNK = 16     # frames a render call holds at once


def background(h: int, w: int) -> np.ndarray:
    """Sky and road gradients with a dashed centre line, (h, w, 3) BGR."""
    horizon = int(0.40 * h)
    img = np.zeros((h, w, 3), np.uint8)
    sky = np.linspace(200, 150, horizon)[:, None]
    img[:horizon] = np.stack([sky * 1.0, sky * 0.92, sky * 0.85],
                             axis=-1).astype(np.uint8)
    road = np.linspace(60, 110, h - horizon)[:, None]
    img[horizon:] = np.stack([road, road, road], axis=-1).astype(np.uint8)
    for y in range(horizon, h, 24):
        half = max(1, (y - horizon) // 40 + 1)
        img[y:y + 12, w // 2 - half:w // 2 + half] = (230, 230, 230)
    return img


class RoadScene:
    """``num_vehicles`` rectangles moving toward the camera with
    perspective growth over the road background, rendered on ``device``
    from integer frame indices."""

    def __init__(self, width: int, height: int, num_vehicles: int,
                 seed: int, device: torch.device):
        self.w, self.h = int(width), int(height)
        self.n_veh = int(num_vehicles)
        self.seed = int(seed)
        self.device = device
        self.bg = torch.from_numpy(background(self.h, self.w)).to(device)
        self.palette = torch.from_numpy(PALETTE.copy()).to(device)
        self.shield = torch.tensor(SHIELD, dtype=torch.uint8, device=device)
        self.yy = torch.arange(self.h, dtype=torch.float32,
                               device=device)[None, :, None]
        self.xx = torch.arange(self.w, dtype=torch.float32,
                               device=device)[None, None, :]

    @torch.inference_mode()
    def render_at(self, idxs) -> torch.Tensor:
        """(B,) frame indices → (B, H, W, 3) uint8 BGR."""
        h, w, n_veh = self.h, self.w, self.n_veh
        horizon = 0.40 * h
        idx = torch.as_tensor(idxs, device=self.device).to(torch.float32)
        img = self.bg[None].expand(idx.shape[0], h, w, 3).clone()
        yy, xx = self.yy, self.xx

        def col(v):
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
            xi1, yi1, xi2, yi2 = (torch.floor(t) for t in (x1, y1, x2, y2))
            visible = col((x2 > 0) & (x1 < w) & (y2 > horizon * 0.5))
            body = (yy >= col(yi1)) & (yy < col(yi2)) \
                & (xx >= col(xi1)) & (xx < col(xi2)) & visible
            img = torch.where(body[..., None],
                              self.palette[v % len(self.palette)], img)
            wy = yi1 + torch.clamp(torch.floor((yi2 - yi1) / 5), min=1.0)
            inset = torch.floor((xi2 - xi1) / 6)
            shield = (yy >= col(yi1)) & (yy < col(wy)) \
                & (xx >= col(xi1 + inset)) & (xx < col(xi2 - inset)) \
                & visible
            img = torch.where(shield[..., None], self.shield, img)
        return img


def camera_seeds(seed: int, cameras: int):
    """Each camera's (scene seed, start frame), drawn from the run's seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7411]))
    scene = rng.integers(0, 2 ** 31 - 1, size=cameras)
    start = rng.integers(0, MAX_START, size=cameras)
    return [(int(a), int(b)) for a, b in zip(scene, start)]


@torch.inference_mode()
def camera_pool(seed: int, cameras: int, clip: int, height: int, width: int,
                vehicles: int, device: torch.device) -> torch.Tensor:
    """(cameras, clip, H, W, 3) uint8: camera i's ``clip`` consecutive
    frames from its own start frame, rendered on ``device``."""
    pool = torch.empty((cameras, clip, height, width, 3), dtype=torch.uint8,
                       device=device)
    for i, (scene_seed, start) in enumerate(camera_seeds(seed, cameras)):
        scene = RoadScene(width, height, vehicles, scene_seed, device)
        for k in range(0, clip, RENDER_CHUNK):
            n = min(RENDER_CHUNK, clip - k)
            pool[i, k:k + n] = scene.render_at(
                torch.arange(start + k, start + k + n, device=device))
    return pool
