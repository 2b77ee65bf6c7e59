"""Detection/tracking overlay rendering — a copy of
``roadvision_tpu/vis/draw.py`` with the numpy paths only (the JAX package
asks its C++ host ops first; both give the same pixels).

Host-side numpy rasterizer — overlay on decoded frames is host work. No cv2
dependency: rectangles are strided slice fills; text uses the 5×7 bitmap
font scaled to approximate cv2's HERSHEY_SIMPLEX metrics at the configured
``font_scale``.

Behavior preserved:
  * per-class color from the same 10-entry table keyed cls_id % 10
    (draw.py:11-22,37);
  * None/degenerate boxes skipped (:35-40);
  * top label "ID {tid} | {cls} {conf:.2f}" on a filled color box with
    white text (:43-47, 59-79);
  * bottom label "{dist:.1f} m / {speed:.1f} km/h" (:49-56, 82-102);
  * edge clamping of label boxes.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import numpy as np

from ..detect.types import Detection
from .font5x7 import GLYPH_H, render_text_mask

COLOR_TABLE: Tuple[Tuple[int, int, int], ...] = (
    (255, 128, 64), (0, 255, 255), (80, 175, 76), (255, 0, 255),
    (0, 128, 255), (255, 64, 64), (64, 255, 64), (128, 128, 255),
    (255, 200, 0), (0, 255, 128),
)

# COCO-17 skeleton edges (as roadvision_tpu/models/yolo/yolov8_pose.py)
SKELETON = ((15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11),
            (6, 12), (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2),
            (0, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 6))


def _font_scale_to_zoom(font_scale: float) -> int:
    # HERSHEY_SIMPLEX cap height ≈ 22 px at scale 1.0; our glyph is 7 px
    return max(1, int(round(font_scale * 22 / GLYPH_H)))


def draw_rect(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
              color, thickness: int = 2) -> None:
    """Axis-aligned rectangle outline, clipped to the image."""
    h, w = img.shape[:2]
    t = max(1, int(thickness))
    color = np.asarray(color, img.dtype)

    def fill(ya, yb, xa, xb):
        ya, yb = max(0, ya), min(h, yb)
        xa, xb = max(0, xa), min(w, xb)
        if ya < yb and xa < xb:
            img[ya:yb, xa:xb] = color

    fill(y1 - t // 2, y1 + (t + 1) // 2, x1, x2 + 1)          # top
    fill(y2 - t // 2, y2 + (t + 1) // 2, x1, x2 + 1)          # bottom
    fill(y1, y2 + 1, x1 - t // 2, x1 + (t + 1) // 2)          # left
    fill(y1, y2 + 1, x2 - t // 2, x2 + (t + 1) // 2)          # right


def fill_rect(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color):
    h, w = img.shape[:2]
    x1, x2 = max(0, x1), min(w, x2)
    y1, y2 = max(0, y1), min(h, y2)
    if x1 < x2 and y1 < y2:
        img[y1:y2, x1:x2] = np.asarray(color, img.dtype)


def put_text(img: np.ndarray, text: str, org: Tuple[int, int],
             color, font_scale: float = 0.6,
             outline: Optional[Tuple[int, int, int]] = None) -> None:
    """Draw text with its BASELINE-left at ``org`` (cv2.putText convention)."""
    zoom = _font_scale_to_zoom(font_scale)
    mask = render_text_mask(text, zoom)
    th, tw = mask.shape
    x, y = int(org[0]), int(org[1]) - th  # top of glyphs
    h, w = img.shape[:2]
    if outline is not None:
        om = np.zeros((th + 2, tw + 2), bool)
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                om[dy:dy + th, dx:dx + tw] |= mask
        _blit(img, om, x - 1, y - 1, outline)
    _blit(img, mask, x, y, color)


def _blit(img, mask, x, y, color):
    h, w = img.shape[:2]
    th, tw = mask.shape
    ya, xa = max(0, y), max(0, x)
    yb, xb = min(h, y + th), min(w, x + tw)
    if ya >= yb or xa >= xb:
        return
    sub = mask[ya - y:yb - y, xa - x:xb - x]
    region = img[ya:yb, xa:xb]
    region[sub] = np.asarray(color, img.dtype)


def text_size(text: str, font_scale: float = 0.6) -> Tuple[Tuple[int, int], int]:
    """((width, height), baseline) approximating cv2.getTextSize."""
    zoom = _font_scale_to_zoom(font_scale)
    w = (len(text) * 6 - 1) * zoom if text else 0
    h = GLYPH_H * zoom
    return (w, h), max(2, zoom)


def draw_detections(image: np.ndarray, detections: Iterable[Detection],
                    thickness: int = 2, font_scale: float = 0.6) -> None:
    """Draw boxes, IDs, distance and speed in place (draw.py:25-56)."""
    thickness = max(1, int(thickness))
    for det in detections:
        if det is None:
            continue
        color = COLOR_TABLE[det.cls_id % len(COLOR_TABLE)]
        x1, y1, x2, y2 = map(int, (det.x1, det.y1, det.x2, det.y2))
        if x2 <= x1 or y2 <= y1:
            continue
        draw_rect(image, x1, y1, x2, y2, color, thickness)

        cls_name = det.cls_name or str(det.cls_id)
        label = f"{cls_name} {det.conf:.2f}" if det.conf is not None else cls_name
        if det.track_id is not None:
            label = f"ID {det.track_id} | {label}"
        _label_top(image, label, (x1, y1), color, font_scale)

        metrics = []
        if det.distance_m is not None:
            metrics.append(f"{det.distance_m:.1f} m")
        if det.speed_kmh is not None:
            metrics.append(f"{det.speed_kmh:.1f} km/h")
        if metrics:
            _label_bottom(image, " / ".join(metrics), (x1, y2 + 4), color,
                          font_scale)


def draw_masks(image: np.ndarray, detections: Iterable[Detection],
               lb_meta=None, alpha: float = 0.45) -> None:
    """Alpha-blend instance masks (segment task) under the box overlay.

    ``detections`` carry prototype-resolution masks
    (the segment task; None masks are skipped);
    ``lb_meta`` is the detector's ``last_letterbox_meta()`` (ratio, pad)
    used to paste them to frame pixels — when None, masks are assumed
    already frame-resolution booleans. Colors follow the same
    cls_id%10 table as the boxes. In-place on the BGR uint8 frame.
    """
    h, w = image.shape[:2]
    dets = [d for d in detections if d.mask is not None]
    if not dets:
        return
    from ..ops.masks import paste_masks
    for d in dets:
        m = np.asarray(d.mask)
        if m.shape == (h, w) and m.dtype == bool:
            full = m
        else:
            if lb_meta is None:
                continue
            ratio, pad = lb_meta
            full = paste_masks(m[None].astype(np.float32),
                               np.array([True]), ratio, pad, (h, w))[0]
        if not full.any():
            continue
        color = np.array(COLOR_TABLE[int(d.cls_id) % 10], np.float32)
        px = image[full].astype(np.float32)
        image[full] = (px * (1.0 - alpha) + color * alpha).astype(np.uint8)


def draw_line(image: np.ndarray, p1, p2, color,
              thickness: int = 1) -> None:
    """Arbitrary-angle line segment by dense point sampling (cv2-free),
    clipped to the image; ``thickness`` grows a square stamp around each
    sample. In-place on the BGR uint8 frame."""
    h, w = image.shape[:2]
    x1, y1 = float(p1[0]), float(p1[1])
    x2, y2 = float(p2[0]), float(p2[1])
    n = max(2, int(np.hypot(x2 - x1, y2 - y1)))
    xs = np.linspace(x1, x2, n).round().astype(int)
    ys = np.linspace(y1, y2, n).round().astype(int)
    r = max(0, int(thickness) // 2)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            px, py = xs + dx, ys + dy
            ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
            image[py[ok], px[ok]] = color


class TrailRenderer:
    """Per-identity motion trails (``vis.draw.trails: N``).

    Beyond-reference overlay (the reference draws only the current
    frame's boxes, src/vis/draw.py:25-56): keeps the last ``length``
    box-bottom-center anchors per track id and draws them as a
    polyline colored by identity (COLOR_TABLE keyed ``track_id % 10``
    so the trail matches nothing-in-particular but stays stable per
    id). Host-side state like the analytics module; identities idle
    past ``stale_after`` seconds are dropped so recycled ids never
    inherit an old trail.
    """

    def __init__(self, length: int = 32, stale_after: float = 2.0):
        self.length = max(2, int(length))
        self.stale_after = float(stale_after)
        self._hist: dict = {}          # id → list[(x, y)]
        self._seen: dict = {}          # id → last ts

    def update(self, detections, timestamp: float) -> None:
        ts = float(timestamp)
        for d in detections:
            tid = getattr(d, "track_id", None)
            if tid is None:
                continue
            tid = int(tid)
            pts = self._hist.setdefault(tid, [])
            pts.append((0.5 * (d.x1 + d.x2), d.y2))
            del pts[:-self.length]
            self._seen[tid] = ts
        for tid in [t for t, last in self._seen.items()
                    if ts - last > self.stale_after]:
            del self._seen[tid]
            del self._hist[tid]

    def draw(self, image: np.ndarray, thickness: int = 2) -> None:
        for tid, pts in self._hist.items():
            if len(pts) < 2:
                continue
            color = COLOR_TABLE[tid % 10]
            for p1, p2 in zip(pts, pts[1:]):
                draw_line(image, p1, p2, color, thickness=thickness)


def draw_keypoints(image: np.ndarray, detections: Iterable[Detection],
                   vis_thresh: float = 0.5, radius: int = 2) -> None:
    """COCO-17 keypoint + skeleton overlay (pose task). Keypoints are
    already in source-frame pixels;
    joints below ``vis_thresh`` visibility are skipped. cv2-free: joints
    are filled squares, bones are dense point sampling along the
    segment. In-place on the BGR uint8 frame."""
    for d in detections:
        if d.keypoints is None:
            continue
        kp = np.asarray(d.keypoints)
        color = COLOR_TABLE[int(d.cls_id) % 10]
        ok = kp[:, 2] >= vis_thresh
        for (a, b) in SKELETON:
            if not (ok[a] and ok[b]):
                continue
            draw_line(image, kp[a, :2], kp[b, :2], color)
        for j in range(kp.shape[0]):
            if not ok[j]:
                continue
            x, y = int(round(kp[j, 0])), int(round(kp[j, 1]))
            fill_rect(image, x - radius, y - radius, x + radius,
                      y + radius, (255, 255, 255))


def draw_rboxes(image: np.ndarray, detections: Iterable[Detection]) -> None:
    """Rotated-box outline overlay (obb task). Each Detection.rbox is
    (cx, cy, w, h, θ) in source-frame pixels; the four edges are drawn
    by dense point sampling (cv2-free), class-colored. In-place on the
    BGR uint8 frame."""
    for d in detections:
        if d.rbox is None:
            continue
        cx, cy, bw, bh, th = (float(v) for v in np.asarray(d.rbox))
        cos, sin = np.cos(th), np.sin(th)
        dx = np.array([bw, bw, -bw, -bw]) / 2.0
        dy = np.array([bh, -bh, -bh, bh]) / 2.0
        xs = cx + dx * cos - dy * sin
        ys = cy + dx * sin + dy * cos
        color = COLOR_TABLE[int(d.cls_id) % 10]
        for i in range(4):
            j = (i + 1) % 4
            draw_line(image, (xs[i], ys[i]), (xs[j], ys[j]), color)


def draw_overlays(image: np.ndarray, detections,
                  lb_meta=None, thickness: int = 2,
                  font_scale: float = 0.6,
                  mask_alpha: float = 0.45) -> None:
    """Boxes plus whichever task payloads the detections carry
    (segment masks under, pose keypoints / obb outlines over) — the
    one-call overlay used by the preview and the MJPEG server.
    ``lb_meta`` (ratio, pad) is required only to paste segment masks;
    in-place on the BGR uint8 frame."""
    dets = list(detections)
    if not dets:
        return
    if lb_meta is not None and any(d.mask is not None for d in dets):
        draw_masks(image, dets, lb_meta, alpha=mask_alpha)
    draw_detections(image, dets, thickness=thickness,
                    font_scale=font_scale)
    if any(d.keypoints is not None for d in dets):
        draw_keypoints(image, dets)
    if any(d.rbox is not None for d in dets):
        draw_rboxes(image, dets)


def _label_top(img, text, topleft, color, font_scale):
    if not text:
        return
    x, y = max(0, int(topleft[0])), max(0, int(topleft[1]))
    (tw, th), baseline = text_size(text, font_scale)
    pad = 2
    box_top = max(0, y - th - baseline - pad * 2)
    fill_rect(img, x, box_top, x + tw + pad * 2, y, color)
    put_text(img, text, (x + pad, max(box_top + th, pad + th)),
             (255, 255, 255), font_scale)


def _label_bottom(img, text, bottomleft, color, font_scale):
    if not text:
        return
    x, y = max(0, int(bottomleft[0])), max(0, int(bottomleft[1]))
    (tw, th), baseline = text_size(text, font_scale)
    pad = 2
    box_top = min(max(0, y), img.shape[0] - th - baseline - pad * 2)
    box_bottom = min(img.shape[0], box_top + th + baseline + pad * 2)
    fill_rect(img, x, box_top, x + tw + pad * 2, box_bottom, color)
    put_text(img, text, (x + pad,
                         min(img.shape[0] - baseline - 1,
                             box_top + th + baseline)),
             (255, 255, 255), font_scale)


def tile_streams(frames, labels=None, divider_px: int = 4,
                 fps: Optional[float] = None) -> np.ndarray:
    """Tile S same-shaped stream frames into one row-major grid canvas.

    The multi-camera analog of :func:`make_canvas` — one tile per mesh
    shard, a near-square grid, per-tile labels top-left. Shared by the
    multi-stream preview and the MJPEG server.
    """
    s = len(frames)
    cols = int(math.ceil(math.sqrt(s)))
    rows = int(math.ceil(s / cols))
    divider_px = max(0, int(divider_px))
    h, w = frames[0].shape[:2]
    canvas = np.full((rows * h + (rows - 1) * divider_px,
                      cols * w + (cols - 1) * divider_px, 3),
                     (40, 40, 40), np.uint8)
    for i, f in enumerate(frames):
        r, c = divmod(i, cols)
        y, x = r * (h + divider_px), c * (w + divider_px)
        canvas[y:y + h, x:x + w] = f
        if labels is not None:
            put_text(canvas, labels[i], (x + 8, y + 24),
                     (50, 220, 50), font_scale=0.8, outline=(0, 0, 0))
    if fps is not None:
        put_text(canvas, f"FPS: {fps:.1f}",
                 (8, canvas.shape[0] - 10), (0, 255, 255),
                 font_scale=0.8, outline=(0, 0, 0))
    return canvas


def make_canvas(raw_bgr: np.ndarray, proc_bgr: np.ndarray, layout: str = "h",
                divider_px: int = 4, label_raw: str = "RAW",
                label_proc: str = "PROC", fps: Optional[float] = None,
                show_fps: bool = True) -> np.ndarray:
    """RAW/PROC compare canvas (reference: main_preview.py:12-34)."""
    h, w = raw_bgr.shape[:2]
    divider_px = max(0, int(divider_px))

    def put_label(img, org, text, color=(50, 220, 50)):
        put_text(img, text, org, color, font_scale=0.8, outline=(0, 0, 0))

    if layout.lower() == "v":
        parts = [raw_bgr]
        if divider_px:
            parts.append(np.full((divider_px, w, 3), (40, 40, 40), np.uint8))
        parts.append(proc_bgr)
        canvas = np.vstack(parts)
        put_label(canvas, (10, 30), label_raw)
        put_label(canvas, (10, h + divider_px + 30), label_proc,
                  color=(0, 200, 255))
    else:
        parts = [raw_bgr]
        if divider_px:
            parts.append(np.full((h, divider_px, 3), (40, 40, 40), np.uint8))
        parts.append(proc_bgr)
        canvas = np.hstack(parts)
        put_label(canvas, (10, 30), label_raw)
        put_label(canvas, (w + divider_px + 10, 30), label_proc,
                  color=(0, 200, 255))

    if show_fps and fps is not None:
        put_label(canvas, (10, max(60, h - 10)), f"FPS: {fps:.1f}",
                  color=(0, 255, 255))
    return canvas
