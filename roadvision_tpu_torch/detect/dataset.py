"""Detection datasets — the port of ``roadvision_tpu/detect/dataset.py``
(numpy and PIL on the host, a copy).

YOLO layout: ``images/*.jpg|png`` with ``labels/<stem>.txt`` lines of
``<cls> <cx> <cy> <w> <h>`` (normalized). COCO layout: an annotation
``.json`` (``images``/``annotations``/``categories``) with image files
resolved relative to it (or ``images_root``); category ids map to
contiguous 0..nc-1 in sorted-id order (the ultralytics convention).
Either way images are letterboxed to the model size; boxes are converted
to pixel xyxy in letterbox space and padded to fixed capacity.
``load_dataset`` dispatches on the path (``.json`` → COCO, directory →
YOLO).

``synthetic_batches`` yields procedurally generated road scenes with
exact ground truth (vehicle class = COCO "car") from the port's
``io_video.capture.SyntheticRoadSource``; given the same seed every
loader, generator and augmentation returns the JAX package's arrays bit
for bit. ``fog_augment_batch`` runs the port's fog synthesizer on
``device`` (the card unless "cpu" is named), within 2 levels of JAX's
in ≤ 0.1 % of the pixels.

Task-family layouts: ``load_yolo_obb_dir`` reads the ultralytics
DOTA/OBB txt convention (``cls x1 y1 ... y4`` normalized quad corners →
(cx, cy, w, h, θ) via :func:`corners_to_rbox`); ``load_coco_kpts_json``
reads COCO person-keypoints annotations; ``load_coco_seg_json``
rasterizes COCO polygon segmentations to prototype-resolution instance
masks (PIL, cv2-free). Each returns the gt convention of its trainer
(models/yolo/train_obb.py / train_pose.py / train_seg.py).
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..io_video.capture import SyntheticRoadSource

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def _letterbox_np(img: np.ndarray, size: int):
    """Host-side letterbox (training data prep): returns image, r, (dw, dh)."""
    from PIL import Image
    h, w = img.shape[:2]
    r = min(size / h, size / w)
    nh, nw = round(h * r), round(w * r)
    resized = np.asarray(Image.fromarray(img).resize((nw, nh),
                                                     Image.BILINEAR))
    out = np.full((size, size, 3), 114, np.uint8)
    top = (size - nh) // 2
    left = (size - nw) // 2
    out[top:top + nh, left:left + nw] = resized
    return out, r, (left, top)


def load_yolo_dir(root: str, imgsz: int = 640, max_boxes: int = 50,
                  limit: Optional[int] = None):
    """Load a YOLO-format dir → (images (N,S,S,3) u8 RGB, boxes (N,M,4),
    cls (N,M), mask (N,M))."""
    from PIL import Image
    root = Path(root)
    img_dir = root / "images" if (root / "images").is_dir() else root
    lbl_dir = root / "labels"
    files = sorted(p for p in img_dir.rglob("*")
                   if p.suffix.lower() in IMG_EXTS)
    if limit:
        files = files[:limit]
    images, boxes_all, cls_all, mask_all = [], [], [], []
    for p in files:
        img = np.asarray(Image.open(p).convert("RGB"))
        h, w = img.shape[:2]
        lb, r, (dw, dh) = _letterbox_np(img, imgsz)
        images.append(lb)
        boxes = np.zeros((max_boxes, 4), np.float32)
        cls = np.zeros((max_boxes,), np.int32)
        mask = np.zeros((max_boxes,), bool)
        lbl = (lbl_dir / (p.stem + ".txt")) if lbl_dir.is_dir() \
            else p.with_suffix(".txt")
        if lbl.exists():
            lines = [ln for ln in lbl.read_text().splitlines() if ln.strip()]
            if len(lines) > max_boxes:
                print(f"[roadvision] {p.name}: {len(lines)} labels truncated "
                      f"to max_boxes={max_boxes} — raise max_boxes for "
                      f"correct eval/training on crowded scenes")
            for i, line in enumerate(lines):
                if i >= max_boxes:
                    break
                parts = line.split()
                c = int(float(parts[0]))
                cx, cy, bw, bh = (float(v) for v in parts[1:5])
                x1 = (cx - bw / 2) * w * r + dw
                y1 = (cy - bh / 2) * h * r + dh
                x2 = (cx + bw / 2) * w * r + dw
                y2 = (cy + bh / 2) * h * r + dh
                boxes[i] = (x1, y1, x2, y2)
                cls[i] = c
                mask[i] = True
        boxes_all.append(boxes)
        cls_all.append(cls)
        mask_all.append(mask)
    if not images:
        raise FileNotFoundError(f"no images under {root}")
    return (np.stack(images), np.stack(boxes_all), np.stack(cls_all),
            np.stack(mask_all))


def load_coco_json(ann_path: str, images_root: Optional[str] = None,
                   imgsz: int = 640, max_boxes: int = 50,
                   limit: Optional[int] = None):
    """Load a COCO-format annotation file → same arrays as load_yolo_dir.

    ``ann_path`` is the instances JSON; image files resolve against
    ``images_root`` (default: the JSON's directory). COCO ``bbox`` is
    [x, y, w, h] in source pixels; ``iscrowd`` regions are excluded from
    eval/training targets per the standard protocol. Returns
    (images (N,S,S,3) u8 RGB, boxes (N,M,4) letterbox-space xyxy,
    cls (N,M) contiguous ids, mask (N,M)), plus ``names`` {cid: name}
    via :func:`coco_names`.
    """
    import json as _json

    from PIL import Image

    ann_path = Path(ann_path)
    root = Path(images_root) if images_root else ann_path.parent
    spec = _json.loads(ann_path.read_text())
    cat_ids = sorted(c["id"] for c in spec.get("categories", []))
    to_contig = {cid: i for i, cid in enumerate(cat_ids)}
    per_image: dict = {}
    for a in spec.get("annotations", []):
        if a.get("iscrowd"):
            continue
        per_image.setdefault(a["image_id"], []).append(a)

    images, boxes_all, cls_all, mask_all = [], [], [], []
    infos = spec.get("images", [])
    if limit:
        infos = infos[:limit]
    for info in infos:
        p = root / info["file_name"]
        img = np.asarray(Image.open(p).convert("RGB"))
        h, w = img.shape[:2]
        lb, r, (dw, dh) = _letterbox_np(img, imgsz)
        images.append(lb)
        boxes = np.zeros((max_boxes, 4), np.float32)
        cls = np.zeros((max_boxes,), np.int32)
        mask = np.zeros((max_boxes,), bool)
        anns = per_image.get(info["id"], [])
        if len(anns) > max_boxes:
            print(f"[roadvision] {p.name}: {len(anns)} annotations "
                  f"truncated to max_boxes={max_boxes} — raise max_boxes "
                  f"for correct eval/training on crowded scenes")
        for i, a in enumerate(anns[:max_boxes]):
            x, y, bw, bh = a["bbox"]
            boxes[i] = (x * r + dw, y * r + dh,
                        (x + bw) * r + dw, (y + bh) * r + dh)
            cls[i] = to_contig.get(a["category_id"], 0)
            mask[i] = True
        boxes_all.append(boxes)
        cls_all.append(cls)
        mask_all.append(mask)
    if not images:
        raise FileNotFoundError(f"no images listed in {ann_path}")
    return (np.stack(images), np.stack(boxes_all), np.stack(cls_all),
            np.stack(mask_all))


def corners_to_rbox(pts: np.ndarray) -> Tuple[float, float, float, float,
                                              float]:
    """(4, 2) quad corners (rectangle order, as in YOLO-OBB labels) →
    (cx, cy, w, h, θ) with w ≥ h and θ ∈ [−π/4, 3π/4) (the range of
    models/yolo/yolov8_obb.decode_angle).

    Opposite edges are averaged so mildly non-rectangular annotation
    quads still yield the least-surprising box (cv2.minAreaRect-free).
    """
    p = np.asarray(pts, np.float32).reshape(4, 2)
    cx, cy = p.mean(axis=0)
    e1 = (p[1] - p[0] + p[2] - p[3]) / 2.0   # first edge pair
    e2 = (p[3] - p[0] + p[2] - p[1]) / 2.0   # second edge pair
    w = float(np.hypot(*e1))
    h = float(np.hypot(*e2))
    th = float(np.arctan2(e1[1], e1[0]))
    if w < h:
        w, h = h, w
        th += np.pi / 2.0
    # ProbIoU is π-periodic in θ; wrap into the decode range
    th = (th + np.pi / 4.0) % np.pi - np.pi / 4.0
    return float(cx), float(cy), w, h, th


def load_yolo_obb_dir(root: str, imgsz: int = 640, max_boxes: int = 50,
                      limit: Optional[int] = None):
    """Load a YOLO-OBB-format dir (the ultralytics DOTA convention:
    label lines ``cls x1 y1 x2 y2 x3 y3 x4 y4`` with normalized quad
    corners) → (images (N,S,S,3) u8 RGB, rboxes (N,M,5) letterbox-space
    cx,cy,w,h px + θ rad, cls (N,M), mask (N,M)) — the gt convention of
    models/yolo/train_obb.py."""
    from PIL import Image
    root = Path(root)
    img_dir = root / "images" if (root / "images").is_dir() else root
    lbl_dir = root / "labels"
    files = sorted(p for p in img_dir.rglob("*")
                   if p.suffix.lower() in IMG_EXTS)
    if limit:
        files = files[:limit]
    images, rb_all, cls_all, mask_all = [], [], [], []
    for p in files:
        img = np.asarray(Image.open(p).convert("RGB"))
        h, w = img.shape[:2]
        lb, r, (dw, dh) = _letterbox_np(img, imgsz)
        images.append(lb)
        rboxes = np.zeros((max_boxes, 5), np.float32)
        cls = np.zeros((max_boxes,), np.int32)
        mask = np.zeros((max_boxes,), bool)
        lbl = (lbl_dir / (p.stem + ".txt")) if lbl_dir.is_dir() \
            else p.with_suffix(".txt")
        if lbl.exists():
            lines = [ln for ln in lbl.read_text().splitlines()
                     if ln.strip()]
            if len(lines) > max_boxes:
                print(f"[roadvision] {p.name}: {len(lines)} labels "
                      f"truncated to max_boxes={max_boxes}")
            for i, line in enumerate(lines[:max_boxes]):
                parts = line.split()
                pts = np.array(parts[1:9], np.float32).reshape(4, 2)
                pts = pts * (w, h) * r + (dw, dh)   # letterbox space
                rboxes[i] = corners_to_rbox(pts)
                cls[i] = int(float(parts[0]))
                mask[i] = True
        rb_all.append(rboxes)
        cls_all.append(cls)
        mask_all.append(mask)
    if not images:
        raise FileNotFoundError(f"no images under {root}")
    return (np.stack(images), np.stack(rb_all), np.stack(cls_all),
            np.stack(mask_all))


def load_coco_kpts_json(ann_path: str, images_root: Optional[str] = None,
                        imgsz: int = 640, max_boxes: int = 50,
                        limit: Optional[int] = None):
    """Load a COCO person-keypoints annotation file → the pose-task
    arrays (images (N,S,S,3) u8 RGB, boxes (N,M,4) letterbox xyxy,
    cls (N,M) all 0, mask (N,M), kpts (N,M,17,3) letterbox px with the
    COCO v flag — v>0 labelled, the convention of
    models/yolo/train_pose.py). Annotations without keypoints
    contribute a box with all joints unlabelled."""
    import json as _json

    from PIL import Image

    ann_path = Path(ann_path)
    root = Path(images_root) if images_root else ann_path.parent
    spec = _json.loads(ann_path.read_text())
    per_image: dict = {}
    for a in spec.get("annotations", []):
        if a.get("iscrowd"):
            continue
        per_image.setdefault(a["image_id"], []).append(a)

    images, boxes_all, cls_all, mask_all, kpts_all = [], [], [], [], []
    infos = spec.get("images", [])
    if limit:
        infos = infos[:limit]
    for info in infos:
        p = root / info["file_name"]
        img = np.asarray(Image.open(p).convert("RGB"))
        lb, r, (dw, dh) = _letterbox_np(img, imgsz)
        images.append(lb)
        boxes = np.zeros((max_boxes, 4), np.float32)
        cls = np.zeros((max_boxes,), np.int32)
        mask = np.zeros((max_boxes,), bool)
        kpts = np.zeros((max_boxes, 17, 3), np.float32)
        anns = per_image.get(info["id"], [])
        if len(anns) > max_boxes:
            print(f"[roadvision] {p.name}: {len(anns)} annotations "
                  f"truncated to max_boxes={max_boxes}")
        for i, a in enumerate(anns[:max_boxes]):
            x, y, bw, bh = a["bbox"]
            boxes[i] = (x * r + dw, y * r + dh,
                        (x + bw) * r + dw, (y + bh) * r + dh)
            mask[i] = True
            kk = np.asarray(a.get("keypoints", []), np.float32)
            if kk.size == 51:
                kk = kk.reshape(17, 3)
                kpts[i, :, 0] = kk[:, 0] * r + dw
                kpts[i, :, 1] = kk[:, 1] * r + dh
                kpts[i, :, 2] = kk[:, 2]
        boxes_all.append(boxes)
        cls_all.append(cls)
        mask_all.append(mask)
        kpts_all.append(kpts)
    if not images:
        raise FileNotFoundError(f"no images listed in {ann_path}")
    return (np.stack(images), np.stack(boxes_all), np.stack(cls_all),
            np.stack(mask_all), np.stack(kpts_all))


def load_coco_seg_json(ann_path: str, images_root: Optional[str] = None,
                       imgsz: int = 640, max_boxes: int = 50,
                       limit: Optional[int] = None):
    """Load a COCO instances annotation file WITH polygon segmentations
    → the segment-task arrays (images, boxes, cls, mask — as
    load_coco_json — plus gt_masks (N,M,S/4,S/4) f32 instance masks at
    PROTOTYPE resolution, the convention of models/yolo/train_seg.py).

    Polygons are transformed to letterbox space and rasterized with
    PIL at S/4 (cv2-free); RLE segmentations are skipped with a notice
    (the annotation still contributes its box)."""
    import json as _json

    from PIL import Image, ImageDraw

    ann_path = Path(ann_path)
    root = Path(images_root) if images_root else ann_path.parent
    spec = _json.loads(ann_path.read_text())
    cat_ids = sorted(c["id"] for c in spec.get("categories", []))
    to_contig = {cid: i for i, cid in enumerate(cat_ids)}
    per_image: dict = {}
    for a in spec.get("annotations", []):
        if a.get("iscrowd"):
            continue
        per_image.setdefault(a["image_id"], []).append(a)

    m4 = imgsz // 4
    rle_skipped = 0
    images, boxes_all, cls_all, mask_all, seg_all = [], [], [], [], []
    infos = spec.get("images", [])
    if limit:
        infos = infos[:limit]
    for info in infos:
        p = root / info["file_name"]
        img = np.asarray(Image.open(p).convert("RGB"))
        lb, r, (dw, dh) = _letterbox_np(img, imgsz)
        images.append(lb)
        boxes = np.zeros((max_boxes, 4), np.float32)
        cls = np.zeros((max_boxes,), np.int32)
        mask = np.zeros((max_boxes,), bool)
        segm = np.zeros((max_boxes, m4, m4), np.float32)
        anns = per_image.get(info["id"], [])
        if len(anns) > max_boxes:
            print(f"[roadvision] {p.name}: {len(anns)} annotations "
                  f"truncated to max_boxes={max_boxes}")
        for i, a in enumerate(anns[:max_boxes]):
            x, y, bw, bh = a["bbox"]
            boxes[i] = (x * r + dw, y * r + dh,
                        (x + bw) * r + dw, (y + bh) * r + dh)
            cls[i] = to_contig.get(a["category_id"], 0)
            mask[i] = True
            seg = a.get("segmentation")
            if isinstance(seg, dict):
                rle_skipped += 1
                continue
            canvas = Image.new("F", (m4, m4), 0.0)
            draw = ImageDraw.Draw(canvas)
            for poly in seg or []:
                pts = np.asarray(poly, np.float32).reshape(-1, 2)
                pts = (pts * r + (dw, dh)) / 4.0
                if len(pts) >= 3:
                    draw.polygon([tuple(q) for q in pts], fill=1.0)
            segm[i] = np.asarray(canvas)
        boxes_all.append(boxes)
        cls_all.append(cls)
        mask_all.append(mask)
        seg_all.append(segm)
    if rle_skipped:
        print(f"[roadvision] {rle_skipped} RLE segmentations skipped "
              "(polygon-only rasterizer); their boxes are kept")
    if not images:
        raise FileNotFoundError(f"no images listed in {ann_path}")
    return (np.stack(images), np.stack(boxes_all), np.stack(cls_all),
            np.stack(mask_all), np.stack(seg_all))


def coco_names(ann_path: str) -> dict:
    """{contiguous_id: category name} for a COCO annotation file."""
    import json as _json
    spec = _json.loads(Path(ann_path).read_text())
    cats = sorted(spec.get("categories", []), key=lambda c: c["id"])
    return {i: c.get("name", str(c["id"])) for i, c in enumerate(cats)}


def load_dataset(path: str, imgsz: int = 640, max_boxes: int = 50,
                 limit: Optional[int] = None):
    """Dispatch on dataset layout: ``.json`` → COCO, directory → YOLO-txt."""
    if str(path).endswith(".json"):
        return load_coco_json(path, imgsz=imgsz, max_boxes=max_boxes,
                              limit=limit)
    return load_yolo_dir(path, imgsz=imgsz, max_boxes=max_boxes,
                         limit=limit)


def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """Vectorized RGB [0,1] → HSV [0,1] (standard hexcone formulas)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.max(axis=-1)
    mn = rgb.min(axis=-1)
    c = mx - mn
    safe = np.where(c > 0, c, 1.0)
    h = np.where(mx == r, ((g - b) / safe) % 6,
                 np.where(mx == g, (b - r) / safe + 2, (r - g) / safe + 4))
    h = np.where(c > 0, h / 6.0, 0.0)
    s = np.where(mx > 0, c / np.where(mx > 0, mx, 1.0), 0.0)
    return np.stack([h, s, mx], axis=-1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.astype(np.int32) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


def mosaic_batch(images: np.ndarray, boxes: np.ndarray, cls: np.ndarray,
                 mask: np.ndarray, rng: np.random.RandomState,
                 min_box: float = 2.0):
    """4-image mosaic composition at the train resolution.

    For each output image, a random split point divides the canvas into
    four quadrants; each quadrant is filled with a random crop from a
    random batch image (self included), and that image's boxes are
    translated, clipped to the quadrant, and kept only if both sides
    stay > ``min_box`` px. Merged boxes are truncated to the fixed
    capacity. This is the composition step of ultralytics' mosaic
    (which composes on a 2S canvas and then random-crops back to S —
    the same distribution of partial objects, one fewer resample).
    """
    n, size = images.shape[0], images.shape[2]
    cap = boxes.shape[1]
    out_i = np.empty_like(images)
    out_b = np.zeros_like(boxes)
    out_c = np.zeros_like(cls)
    out_m = np.zeros_like(mask)
    for i in range(n):
        sx = rng.randint(int(0.3 * size), int(0.7 * size) + 1)
        sy = rng.randint(int(0.3 * size), int(0.7 * size) + 1)
        quads = [(0, 0, sx, sy), (sx, 0, size, sy),
                 (0, sy, sx, size), (sx, sy, size, size)]
        srcs = [i] + list(rng.randint(0, n, 3))
        k = 0
        for (x1, y1, x2, y2), j in zip(quads, srcs):
            qw, qh = x2 - x1, y2 - y1
            ox = rng.randint(0, size - qw + 1)
            oy = rng.randint(0, size - qh + 1)
            out_i[i, y1:y2, x1:x2] = images[j, oy:oy + qh, ox:ox + qw]
            dx, dy = x1 - ox, y1 - oy
            for s in range(cap):
                if not mask[j, s] or k >= cap:
                    continue
                bx1 = np.clip(boxes[j, s, 0] + dx, x1, x2)
                by1 = np.clip(boxes[j, s, 1] + dy, y1, y2)
                bx2 = np.clip(boxes[j, s, 2] + dx, x1, x2)
                by2 = np.clip(boxes[j, s, 3] + dy, y1, y2)
                if bx2 - bx1 > min_box and by2 - by1 > min_box:
                    out_b[i, k] = (bx1, by1, bx2, by2)
                    out_c[i, k] = cls[j, s]
                    out_m[i, k] = True
                    k += 1
    return out_i, out_b, out_c, out_m


def augment_batch(images: np.ndarray, boxes: np.ndarray, mask: np.ndarray,
                  rng: np.random.RandomState,
                  hflip_p: float = 0.5, hsv_h: float = 0.015,
                  hsv_s: float = 0.7, hsv_v: float = 0.4):
    """Standard train-time augmentation (the ultralytics default recipe
    minus mosaic): per-image horizontal flip with box mirroring, and HSV
    hue/saturation/value jitter with the same gain ranges. Host-side
    numpy on uint8 RGB; returns (images, boxes) — cls/mask unaffected.
    """
    n, size = images.shape[0], images.shape[2]
    images = images.copy()
    boxes = boxes.copy()
    for i in range(n):
        if rng.rand() < hflip_p:
            images[i] = images[i, :, ::-1]
            x1 = boxes[i, :, 0].copy()
            boxes[i, :, 0] = np.where(mask[i], size - boxes[i, :, 2], x1)
            boxes[i, :, 2] = np.where(mask[i], size - x1, boxes[i, :, 2])
        gh, gs, gv = rng.uniform(-1, 1, 3) * [hsv_h, hsv_s, hsv_v] + 1
        hsv = _rgb_to_hsv(images[i].astype(np.float32) / 255.0)
        hsv[..., 0] = (hsv[..., 0] * gh) % 1.0
        hsv[..., 1] = np.clip(hsv[..., 1] * gs, 0, 1)
        hsv[..., 2] = np.clip(hsv[..., 2] * gv, 0, 1)
        images[i] = (np.clip(_hsv_to_rgb(hsv), 0, 1) * 255 + 0.5
                     ).astype(np.uint8)
    return images, boxes


def synthetic_batches(batch: int, imgsz: int = 320, max_boxes: int = 12,
                      num_vehicles: int = 5, seed: int = 0,
                      car_class: int = 2) -> Iterator[Tuple[np.ndarray, ...]]:
    """Endless generator of (images RGB f-ready u8, boxes, cls, mask)."""
    src = SyntheticRoadSource(imgsz, imgsz, num_vehicles=num_vehicles,
                              seed=seed)
    idx = 0
    while True:
        imgs, boxes_b, cls_b, mask_b = [], [], [], []
        for _ in range(batch):
            img = src.render(idx)[..., ::-1]  # BGR → RGB
            gts = src.gt_boxes(idx)
            boxes = np.zeros((max_boxes, 4), np.float32)
            cls = np.zeros((max_boxes,), np.int32)
            mask = np.zeros((max_boxes,), bool)
            for i, (x1, y1, x2, y2, _v) in enumerate(gts[:max_boxes]):
                boxes[i] = (x1, y1, x2, y2)
                cls[i] = car_class
                mask[i] = True
            imgs.append(img)
            boxes_b.append(boxes)
            cls_b.append(cls)
            mask_b.append(mask)
            idx += 1
        yield (np.stack(imgs), np.stack(boxes_b), np.stack(cls_b),
               np.stack(mask_b))


def synthetic_seg_batches(batch: int, imgsz: int = 320,
                          max_boxes: int = 12, num_vehicles: int = 5,
                          seed: int = 0, car_class: int = 2
                          ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Segment-task variant of :func:`synthetic_batches`: adds per-slot
    instance masks at PROTOTYPE resolution (imgsz/4, the convention of
    models/yolo/train_seg.py). The synthetic vehicles are ellipses
    inscribed in their boxes — a non-trivial mask the box alone cannot
    reproduce, so the mask loss has something to learn.

    Yields (images (B,S,S,3) u8 RGB, boxes (B,M,4), cls (B,M) i32,
    valid (B,M) bool, masks (B,M,S/4,S/4) f32).
    """
    m4 = imgsz // 4
    yy, xx = np.mgrid[0:m4, 0:m4].astype(np.float32)
    for imgs, boxes, cls, valid in synthetic_batches(
            batch, imgsz, max_boxes, num_vehicles, seed, car_class):
        masks = np.zeros(boxes.shape[:2] + (m4, m4), np.float32)
        bb = boxes / 4.0
        for b in range(boxes.shape[0]):
            for m in range(boxes.shape[1]):
                if not valid[b, m]:
                    continue
                x1, y1, x2, y2 = bb[b, m]
                cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
                rx = max((x2 - x1) / 2, 0.5)
                ry = max((y2 - y1) / 2, 0.5)
                masks[b, m] = (((xx - cx) / rx) ** 2
                               + ((yy - cy) / ry) ** 2 <= 1.0)
        yield imgs, boxes, cls, valid, masks


def synthetic_obb_batches(batch: int, imgsz: int = 320,
                          max_boxes: int = 12, num_objects: int = 5,
                          seed: int = 0, obj_class: int = 9
                          ) -> Iterator[Tuple[np.ndarray, ...]]:
    """OBB-task synthetic scenes: rotated rectangles ("vehicles seen
    from above" — DOTA-style) on the road background, with exact
    (cx, cy, w, h, θ) ground truth (the convention of
    models/yolo/train_obb.py — input pixels, θ ∈ [−π/4, 3π/4), the
    range of yolov8_obb.decode_angle).

    Rectangles are elongated (w ≫ h) so the angle is observable from
    pixels — a square would make θ unlearnable — and filled with a
    bright per-object color plus a darker "cab" stripe at the +w end,
    breaking the remaining 180° symmetry's effect on the box term (the
    loss itself is Gaussian-symmetric, matching ProbIoU).
    Class defaults to 9 ("large vehicle" in DOTA_NAMES).

    Yields (images (B,S,S,3) u8 RGB, rboxes (B,M,5), cls (B,M) i32,
    valid (B,M) bool).
    """
    src = SyntheticRoadSource(imgsz, imgsz, num_vehicles=0, seed=seed)
    rng = np.random.RandomState(seed + 31)
    yy, xx = np.mgrid[0:imgsz, 0:imgsz].astype(np.float32)
    idx = 0
    while True:
        out = []
        for _ in range(batch):
            img = np.ascontiguousarray(src.render(idx)[..., ::-1])
            rboxes = np.zeros((max_boxes, 5), np.float32)
            cls = np.zeros((max_boxes,), np.int32)
            valid = np.zeros((max_boxes,), bool)
            for m in range(min(num_objects, max_boxes)):
                w = rng.uniform(0.18, 0.30) * imgsz
                h = w * rng.uniform(0.35, 0.55)
                th = rng.uniform(-np.pi / 4, 3 * np.pi / 4)
                # keep the rotated extent inside the frame
                rx = (w * abs(np.cos(th)) + h * abs(np.sin(th))) / 2
                ry = (w * abs(np.sin(th)) + h * abs(np.cos(th))) / 2
                cx = rng.uniform(rx + 2, imgsz - rx - 2)
                cy = rng.uniform(ry + 2, imgsz - ry - 2)
                rboxes[m] = (cx, cy, w, h, th)
                cls[m] = obj_class
                valid[m] = True
                # rasterize: pixel centers inside the rotated rect
                dx, dy = xx - cx, yy - cy
                lx = dx * np.cos(th) + dy * np.sin(th)
                ly = -dx * np.sin(th) + dy * np.cos(th)
                body = (np.abs(lx) <= w / 2) & (np.abs(ly) <= h / 2)
                img[body] = rng.randint(150, 256, 3)
                cab = body & (lx > w * 0.25)
                img[cab] = rng.randint(30, 90, 3)
            out.append((img, rboxes, cls, valid))
            idx += 1
        yield tuple(np.stack([o[i] for o in out]) for i in range(4))


# Canonical 17-keypoint stick-figure layout, normalized to the person
# box (x, y in [0,1]): COCO order nose, eyes, ears, shoulders, elbows,
# wrists, hips, knees, ankles.
_POSE_LAYOUT = np.array([
    (0.50, 0.08),                       # nose
    (0.44, 0.05), (0.56, 0.05),         # eyes
    (0.38, 0.08), (0.62, 0.08),         # ears
    (0.35, 0.25), (0.65, 0.25),         # shoulders
    (0.28, 0.42), (0.72, 0.42),         # elbows
    (0.25, 0.58), (0.75, 0.58),         # wrists
    (0.40, 0.55), (0.60, 0.55),         # hips
    (0.38, 0.75), (0.62, 0.75),         # knees
    (0.37, 0.95), (0.63, 0.95),         # ankles
], np.float32)


def synthetic_pose_batches(batch: int, imgsz: int = 320,
                           max_boxes: int = 8, num_people: int = 3,
                           seed: int = 0
                           ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Pose-task synthetic scenes: stick-figure "people" on the road
    background, with exact 17-keypoint ground truth (the convention of
    models/yolo/train_pose.py — x, y in input pixels, v>0 labelled).

    Figures are the canonical layout jittered per joint and drawn into
    the image (bright joints + limb strokes) so the keypoint loss has
    pixel evidence to learn from; ~2 joints per figure are dropped
    (v=0) to exercise the labelled-joint masking. Class is always 0
    ("person" — pose checkpoints are single-class).

    Yields (images (B,S,S,3) u8 RGB, boxes (B,M,4), cls (B,M) i32,
    valid (B,M) bool, kpts (B,M,17,3) f32).
    """
    src = SyntheticRoadSource(imgsz, imgsz, num_vehicles=0, seed=seed)
    rng = np.random.RandomState(seed + 17)
    idx = 0
    while True:
        out = []
        for _ in range(batch):
            img = np.ascontiguousarray(src.render(idx)[..., ::-1])
            boxes = np.zeros((max_boxes, 4), np.float32)
            cls = np.zeros((max_boxes,), np.int32)
            valid = np.zeros((max_boxes,), bool)
            kpts = np.zeros((max_boxes, 17, 3), np.float32)
            for m in range(min(num_people, max_boxes)):
                w = rng.uniform(0.10, 0.20) * imgsz
                h = rng.uniform(0.28, 0.45) * imgsz
                x1 = rng.uniform(2, imgsz - w - 2)
                y1 = rng.uniform(2, imgsz - h - 2)
                boxes[m] = (x1, y1, x1 + w, y1 + h)
                valid[m] = True
                kp = _POSE_LAYOUT + rng.uniform(-0.02, 0.02, (17, 2))
                kp = np.stack([x1 + kp[:, 0] * w, y1 + kp[:, 1] * h], -1)
                vis = np.ones(17, np.float32)
                vis[rng.choice(17, size=2, replace=False)] = 0.0
                kpts[m, :, :2] = kp
                kpts[m, :, 2] = vis
                # draw: limb strokes then bright joints (only labelled)
                color = rng.randint(180, 256, 3)
                from ..vis.draw import SKELETON
                for a, b in SKELETON:
                    if not (vis[a] and vis[b]):
                        continue
                    n = max(2, int(np.hypot(*(kp[b] - kp[a]))))
                    xs = np.linspace(kp[a, 0], kp[b, 0], n).astype(int)
                    ys = np.linspace(kp[a, 1], kp[b, 1], n).astype(int)
                    ok = (xs >= 0) & (xs < imgsz) & (ys >= 0) & (ys < imgsz)
                    img[ys[ok], xs[ok]] = color
                for j in range(17):
                    if not vis[j]:
                        continue
                    x, y = int(kp[j, 0]), int(kp[j, 1])
                    img[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2] = \
                        (255, 255, 255)
            out.append((img, boxes, cls, valid, kpts))
            idx += 1
        yield tuple(np.stack([o[i] for o in out]) for i in range(5))


def fog_augment_batch(images: np.ndarray, rng: np.random.RandomState,
                      p: float = 0.5, level: str = "random",
                      device=None) -> np.ndarray:
    """Train-time weather augmentation (``fog_augment_batch`` :689): the
    atmospheric-scattering fog synthesizer (augment/fog.py) on a random
    subset of the uint8 BGR batch, synthesized on ``device``. Photometric
    only — boxes / masks / keypoints are untouched, so it composes with
    every task's objective. ``level`` is light / medium / heavy, or
    "random" to sample per image; ``rng`` draws as JAX's does."""
    from ..augment.fog import EnhancedFogSynthesizer

    levels = ("light", "medium", "heavy")
    out = np.array(images, copy=True)
    for i in range(out.shape[0]):
        if rng.rand() >= p:
            continue
        lvl = level if level in levels else levels[rng.randint(3)]
        syn = EnhancedFogSynthesizer(level=lvl,
                                     seed=int(rng.randint(2 ** 31)),
                                     device=device)
        hazy, _meta = syn.synthesize(out[i])
        out[i] = hazy
    return out
