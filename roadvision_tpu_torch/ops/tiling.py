"""Tiled (sliced) inference for small objects — the port of
``roadvision_tpu/ops/tiling.py``.

A static grid of overlapping native-resolution tiles per (H, W)
(:func:`tile_plan`), cut by slicing (:func:`extract_tiles`), all tiles of
all frames through ONE batched forward, each tile's boxes mapped into
the source frame, plus the full-frame pass; one class-aware NMS then
merges everything (:func:`tiled_candidates` returns the candidates).
At 1080p with tile 640 and overlap 0.25 that is 2 × 4 tiles and the
full frame: 9 canvases a frame.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .letterbox import scale_boxes


class TilePlan(NamedTuple):
    """Static tile grid for one (H, W) geometry."""
    offsets: Tuple[Tuple[int, int], ...]   # (y, x) slice origins
    th: int                                # tile height
    tw: int                                # tile width

    @property
    def num_tiles(self) -> int:
        return len(self.offsets)


def _axis_offsets(dim: int, tile: int, overlap: float) -> Tuple[int, ...]:
    """Evenly spaced origins covering [0, dim), ≥ ``overlap`` between
    neighbours, the last tile flush with the edge."""
    if dim <= tile:
        return (0,)
    stride = max(1, tile - int(round(tile * overlap)))
    n = math.ceil((dim - tile) / stride) + 1
    return tuple(round(i * (dim - tile) / (n - 1)) for i in range(n))


def tile_plan(h: int, w: int, tile: int = 640,
              overlap: float = 0.25) -> TilePlan:
    th, tw = min(tile, h), min(tile, w)
    ys = _axis_offsets(h, th, overlap)
    xs = _axis_offsets(w, tw, overlap)
    return TilePlan(tuple((y, x) for y in ys for x in xs), th, tw)


def extract_tiles(frames: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """(B, H, W, C) → (B, T, th, tw, C)."""
    return torch.stack([frames[:, y:y + plan.th, x:x + plan.tw]
                        for (y, x) in plan.offsets], dim=1)


def tiled_candidates(det, frames_u8: torch.Tensor, plan: TilePlan,
                     full_frame: bool = True):
    """Pre-NMS candidates of the tiled pass in SOURCE pixels: (boxes
    (B, T·A [+ A], 4), scores (B, ·, nc)). ``det`` needs ``letterbox`` and
    ``forward`` (the detect task's boxes and scores)."""
    if frames_u8.dim() == 3:
        frames_u8 = frames_u8[None]
    b, h, w = frames_u8.shape[:3]
    t = plan.num_tiles
    tiles = extract_tiles(frames_u8, plan)
    imgs, ratio, pad = det.letterbox(
        tiles.reshape((b * t, plan.th, plan.tw) + tiles.shape[4:]))
    boxes_lb, scores = det.forward(imgs)
    boxes_tile = scale_boxes(boxes_lb, ratio, pad, (plan.th, plan.tw))
    a = boxes_tile.shape[1]
    off = torch.tensor([(x, y, x, y) for (y, x) in plan.offsets],
                       dtype=torch.float32, device=frames_u8.device)
    boxes_all = (boxes_tile.reshape(b, t, a, 4) + off[None, :, None, :]) \
        .reshape(b, t * a, 4)
    scores_all = scores.reshape(b, t * a, scores.shape[-1])
    if full_frame and (h > plan.th or w > plan.tw):
        imgs_f, ratio_f, pad_f = det.letterbox(frames_u8)
        boxes_f, scores_f = det.forward(imgs_f)
        boxes_f = scale_boxes(boxes_f, ratio_f, pad_f, (h, w))
        boxes_all = torch.cat([boxes_all, boxes_f], dim=1)
        scores_all = torch.cat([scores_all, scores_f], dim=1)
    return boxes_all, scores_all
