"""Letterbox resize and the inverse box mapping — the port of
``roadvision_tpu/ops/letterbox.py:19-215`` (``finish_letterbox``
included: the pad-and-normalise tail for a frame that is already
resized; ``letterbox_meta``, the host-side (ratio, pad); and
``resize_stretch_u8``, the aspect-distorting resize RT-DETR predicts
with).

Half-pixel bilinear resize without antialias (cv2 INTER_LINEAR, what
ultralytics letterboxes with), BGR→RGB, gray-114 pad, /255, NHWC float32
out. An exact integer downscale with an odd stride is a strided slice of
the uint8 frame (1080p → 360×640 is stride 3), an even stride a 2-tap
average; anything else ("general") applies the weight matrix
``jax.image.resize(method="linear", antialias=False)`` builds (computed
here in numpy float32 the same way) by its nonzero taps: without
antialias each output sample has at most two, so the axis is two
gathers, two products and a sum, each rounded alone — the same bits on
the card and on the CPU, where a dense contraction would sum in another
order on each (and take ~20 ms for a 1080p batch on the card).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import device_constant


_INV_255 = float(np.float32(1.0 / 255.0))


def axis_plan(src: int, dst: int):
    """("id",) | ("slice", s, off) | ("avg2", s, off) | ("general",)."""
    if src == dst:
        return ("id",)
    if src % dst == 0:
        s = src // dst
        if s % 2 == 1:
            return ("slice", s, (s - 1) // 2)
        return ("avg2", s, s // 2 - 1)
    return ("general",)


def linear_weight_matrix(src: int, dst: int) -> np.ndarray:
    """(src, dst) float32 weights of jax's linear resize, antialias off:
    triangle kernel at half-pixel sample points, columns renormalised,
    samples outside [-0.5, src-0.5] zeroed."""
    scale = np.float32(dst) / np.float32(src)
    inv = np.float32(1.0) / scale
    sample = ((np.arange(dst, dtype=np.float32) + np.float32(0.5)) * inv
              - np.float32(0.5)).astype(np.float32)
    x = np.abs(sample[None, :] - np.arange(src, dtype=np.float32)[:, None])
    wts = np.maximum(np.float32(0.0), np.float32(1.0) - x).astype(np.float32)
    total = wts.sum(axis=0, keepdims=True, dtype=np.float32)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    wts = np.where(np.abs(total) > eps,
                   wts / np.where(total != 0, total, np.float32(1.0)),
                   np.float32(0.0)).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.where(inside[None, :], wts, np.float32(0.0)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def linear_taps(src: int, dst: int, device: torch.device):
    """:func:`linear_weight_matrix` by its nonzero entries, on ``device``
    (built once per geometry): (index (k, dst) int64, weight (k, dst)
    float32), k the most taps any output sample has; unused taps point
    at row 0 with weight 0."""
    wm = linear_weight_matrix(src, dst)
    nz = wm != 0
    k = max(1, int(nz.sum(axis=0).max()))
    idx = np.zeros((k, dst), np.int64)
    wts = np.zeros((k, dst), np.float32)
    for j in range(dst):
        rows = np.nonzero(nz[:, j])[0]
        idx[:len(rows), j] = rows
        wts[:len(rows), j] = wm[rows, j]
    return torch.from_numpy(idx).to(device), torch.from_numpy(wts).to(device)


def _resize_axis_taps(v: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """The general plan on one axis of (B, H, W, C): Σ_t w_t · v[idx_t],
    tap by tap, in float32."""
    idx, wts = linear_taps(v.shape[axis], n, v.device)
    shape = [1] * v.dim()
    shape[axis] = n
    out = None
    for i, w in zip(idx, wts):
        g = v.index_select(axis, i).to(torch.float32) * w.reshape(shape)
        out = g if out is None else out + g
    return out


def resize_linear(x: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """(B, H, W, C) → (B, new_h, new_w, C) float32, as
    ``jax.image.resize(method="linear", antialias=False)``: the weight
    matrices applied by their taps, rows first."""
    if x.shape[1] != new_h:
        x = _resize_axis_taps(x, 1, new_h)
    if x.shape[2] != new_w:
        x = _resize_axis_taps(x, 2, new_w)
    return x.to(torch.float32)


def _bilinear_resize(x: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """(B, H, W, C) uint8 → (B, new_h, new_w, C) float32."""
    h, w = x.shape[1], x.shape[2]
    py, px = axis_plan(h, new_h), axis_plan(w, new_w)

    def apply(v, plan, axis):
        if plan[0] == "id":
            return v
        n = new_h if axis == 1 else new_w
        if plan[0] == "general":
            return _resize_axis_taps(v, axis, n)
        s, off = plan[1], plan[2]
        idx = torch.arange(off, off + s * n, s, device=v.device)
        if plan[0] == "slice":
            return v.index_select(axis, idx)
        a = v.index_select(axis, idx).to(torch.float32)
        b = v.index_select(axis, idx + 1).to(torch.float32)
        return (a + b) * 0.5

    # slices first (they shrink the frame and are exact), then rows
    # before columns, as the JAX resize contracts them
    plans = sorted(((py, 1), (px, 2)), key=lambda p: p[0][0] != "slice")
    for plan, axis in plans:
        x = apply(x, plan, axis)
    return x.to(torch.float32)


def rect_target_hw(h: int, w: int, size: int = 640,
                   stride: int = 32) -> Tuple[int, int]:
    """Minimal stride-aligned canvas, e.g. 1080p → (384, 640)."""
    r = min(size / h, size / w)
    new_h, new_w = round(h * r), round(w * r)
    return new_h + (-new_h) % stride, new_w + (-new_w) % stride


def _scaled_hw(h: int, w: int, size: int):
    r = min(size / h, size / w)
    return r, round(h * r), round(w * r)


def _canvas(resized_bgr: torch.Tensor, r: float, th: int, tw: int):
    """(B, new_h, new_w, 3) resized BGR (uint8 or float32) → the padded,
    normalised RGB canvas with its (ratio, pad)."""
    new_h, new_w = resized_bgr.shape[1], resized_bgr.shape[2]
    dw, dh = (tw - new_w) / 2, (th - new_h) / 2
    x = resized_bgr.to(torch.float32).flip(-1)          # BGR → RGB
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    bottom, right = th - new_h - top, tw - new_w - left
    x = F.pad(x, (0, 0, left, right, top, bottom), value=114.0)
    # constants made once (a captured step cannot upload them)
    dev = resized_bgr.device
    ratio = device_constant(r, torch.float32, dev)
    pad = device_constant([left, top], torch.float32, dev)
    # x * float32(1/255): XLA rewrites the JAX package's ``x / 255.0``
    # into this multiply, so the canvas is bit-equal to the reference's
    return x * _INV_255, ratio, pad


def _letterbox(frames: torch.Tensor, size: int, th: int, tw: int):
    if frames.dim() == 3:
        frames = frames[None]
    r, new_h, new_w = _scaled_hw(frames.shape[1], frames.shape[2], size)
    # resize first, then BGR → RGB: the channel flip commutes with the
    # per-channel resize and touches only the small canvas
    return _canvas(_bilinear_resize(frames, new_h, new_w), r, th, tw)


def letterbox_u8(frames: torch.Tensor, size: int = 640):
    """(B, H, W, 3) uint8 BGR → ((B, size, size, 3) float32 RGB in [0, 1],
    ratio, pad (left, top))."""
    return _letterbox(frames, size, size, size)


def letterbox_rect_u8(frames: torch.Tensor, size: int = 640,
                      stride: int = 32):
    """Rect variant: the canvas is the minimal stride-aligned rectangle
    (ultralytics' predict-time ``LetterBox(auto=True)``)."""
    h, w = frames.shape[-3], frames.shape[-2]
    th, tw = rect_target_hw(h, w, size, stride)
    return _letterbox(frames, size, th, tw)


def finish_letterbox(resized_bgr: torch.Tensor, orig_hw: Tuple[int, int],
                     size: int = 640, stride: int = 32, rect: bool = True):
    """Pad and normalise an ALREADY-resized (B, new_h, new_w, 3) uint8
    BGR batch, e.g. the sampled preprocess path's output: exactly what
    :func:`letterbox_u8` / :func:`letterbox_rect_u8` give for the
    original (h, w) frame, with the same (ratio, pad)."""
    h, w = orig_hw
    r, new_h, new_w = _scaled_hw(h, w, size)
    if tuple(resized_bgr.shape[1:3]) != (new_h, new_w):
        raise ValueError(f"a {h}x{w} frame letterboxes to {new_h}x{new_w}, "
                         f"got {tuple(resized_bgr.shape[1:3])}")
    th, tw = rect_target_hw(h, w, size, stride) if rect else (size, size)
    return _canvas(resized_bgr, r, th, tw)


def letterbox_meta(h: int, w: int, size: int = 640, rect: bool = True,
                   stride: int = 32) -> Tuple[float, Tuple[float, float]]:
    """Host-side (ratio, (left, top)) for a source geometry: what
    :func:`letterbox_u8` / :func:`letterbox_rect_u8` return as device
    scalars, without running the transform."""
    r, new_h, new_w = _scaled_hw(h, w, size)
    th, tw = rect_target_hw(h, w, size, stride) if rect else (size, size)
    dw, dh = (tw - new_w) / 2, (th - new_h) / 2
    return r, (float(int(round(dw - 0.1))), float(int(round(dh - 0.1))))


def resize_stretch_u8(frames: torch.Tensor, size: int = 640) -> torch.Tensor:
    """(B, H, W, 3) uint8 BGR → (B, size, size, 3) float32 RGB in [0, 1]:
    a plain stretch resize, no pad and no ratio (the RT-DETR predict
    convention). Normalised by ``* float32(1/255)`` like the letterbox
    canvas, which is what XLA makes of the JAX function's ``/ 255.0``."""
    if frames.dim() == 3:
        frames = frames[None]
    return _bilinear_resize(frames, size, size).flip(-1) * _INV_255


def scale_boxes(boxes: torch.Tensor, ratio, pad,
                orig_hw: Tuple[int, int]) -> torch.Tensor:
    """Boxes in letterbox space → source-image space, clipped."""
    h, w = orig_hw
    x1 = ((boxes[..., 0] - pad[0]) / ratio).clamp(0, w)
    y1 = ((boxes[..., 1] - pad[1]) / ratio).clamp(0, h)
    x2 = ((boxes[..., 2] - pad[0]) / ratio).clamp(0, w)
    y2 = ((boxes[..., 3] - pad[1]) / ratio).clamp(0, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)
