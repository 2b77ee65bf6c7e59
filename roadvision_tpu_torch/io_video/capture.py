"""Frame sources — a trimmed copy of ``roadvision_tpu/io_video/capture.py``
(``Frame``, ``SyntheticRoadSource`` and the ``VideoSource`` facade).

``VideoSource`` takes ``"synthetic"`` or ``"synthetic:<num_vehicles>"``
and stamps frames with paced timestamps ``t0 + index / fps``; cameras,
files and the other sources are not ported yet and raise.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np


class Frame:
    __slots__ = ("ok", "image", "ts")

    def __init__(self, ok: bool, image: Optional[np.ndarray], ts: float):
        self.ok = ok
        self.image = image
        self.ts = ts


class SyntheticRoadSource:
    """Procedural road scene: gradient sky/road, a dashed lane line, and
    ``num_vehicles`` rectangles moving toward the camera with perspective
    growth. Deterministic in the frame index; exposes ground-truth boxes.
    """

    _PALETTE = np.array([
        (48, 48, 200), (200, 48, 48), (48, 180, 48), (32, 160, 220),
        (160, 64, 160), (64, 200, 200), (220, 160, 32), (96, 96, 96),
    ], dtype=np.uint8)

    def __init__(self, width: int = 640, height: int = 480,
                 num_vehicles: int = 4, num_frames: Optional[int] = None,
                 seed: int = 0):
        self.w, self.h = int(width), int(height)
        self.n_veh = int(num_vehicles)
        self.num_frames = num_frames
        self.seed = int(seed)
        self.idx = 0
        self._bg = self._background()

    def _background(self) -> np.ndarray:
        h, w = self.h, self.w
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

    def gt_boxes(self, idx: int) -> List[Tuple[float, float, float, float,
                                               int]]:
        """Ground-truth (x1, y1, x2, y2, vehicle_id) at frame ``idx``."""
        horizon = 0.40 * self.h
        out = []
        for v in range(self.n_veh):
            speed = 0.006 + 0.003 * ((v * 7 + self.seed) % 5)
            prog = ((idx * speed) + v / max(1, self.n_veh)) % 1.0
            yc = horizon + prog * (self.h - horizon) * 0.95
            scale = 0.25 + 0.75 * prog
            bw = 0.11 * self.w * scale
            bh = 0.09 * self.h * scale
            lane = -1 if v % 2 == 0 else 1
            xc = self.w / 2 + lane * (0.12 + 0.10 * prog) * self.w \
                + 0.02 * self.w * np.sin(idx * 0.05 + v)
            x1, y1 = xc - bw / 2, yc - bh
            x2, y2 = xc + bw / 2, yc
            if x2 <= 0 or x1 >= self.w or y2 <= horizon * 0.5:
                continue
            out.append((float(max(0, x1)), float(max(0, y1)),
                        float(min(self.w - 1, x2)),
                        float(min(self.h - 1, y2)), v))
        return out

    def render(self, idx: int) -> np.ndarray:
        img = self._bg.copy()
        for x1, y1, x2, y2, v in self.gt_boxes(idx):
            xi1, yi1, xi2, yi2 = map(int, (x1, y1, x2, y2))
            img[yi1:yi2, xi1:xi2] = self._PALETTE[v % len(self._PALETTE)]
            wy = yi1 + max(1, (yi2 - yi1) // 5)
            img[yi1:wy, xi1 + (xi2 - xi1) // 6: xi2 - (xi2 - xi1) // 6] = \
                (210, 220, 225)
        return img

    def read_frame(self):
        if self.num_frames is not None and self.idx >= self.num_frames:
            return False, None
        img = self.render(self.idx)
        self.idx += 1
        return True, img

    def release(self) -> None:
        pass


def _resolve(source, width, height, num_frames):
    if isinstance(source, str):
        low = source.lower()
        if low == "synthetic" or (low.startswith("synthetic:")
                                  and low.split(":", 1)[1].isdigit()):
            n = int(low.split(":", 1)[1]) if ":" in low else 4
            return SyntheticRoadSource(width, height, num_vehicles=n,
                                       num_frames=num_frames)
    raise NotImplementedError(
        f"frame source {source!r} is not ported to roadvision_tpu_torch yet "
        f"('synthetic' or 'synthetic:<num_vehicles>')")


class VideoSource:
    """``read() -> Frame`` and ``read_batch(n)`` over a ported source."""

    def __init__(self, source="synthetic", width=1280, height=720,
                 fps_request=30, backend: str = "auto",
                 num_frames: Optional[int] = None):
        del backend
        self._src = _resolve(source, width, height, num_frames)
        self._fps = max(1e-3, float(fps_request or 30))
        self._t0 = time.time()
        self._idx = 0

    def read(self) -> Frame:
        ok, img = self._src.read_frame()
        ts = self._t0 + self._idx / self._fps
        if ok:
            self._idx += 1
        return Frame(ok, img, ts)

    def read_batch(self, n: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """(frames (m, H, W, 3) uint8, timestamps (m,) float64, m)."""
        frames, stamps = [], []
        for _ in range(n):
            fr = self.read()
            if not fr.ok:
                break
            frames.append(fr.image)
            stamps.append(fr.ts)
        if not frames:
            return (np.zeros((0, 0, 0, 3), np.uint8),
                    np.zeros((0,), np.float64), 0)
        return np.stack(frames), np.asarray(stamps, np.float64), len(frames)

    def release(self) -> None:
        self._src.release()
