"""Detection data contract — a copy of ``roadvision_tpu/detect/types.py``.

``Detection`` is the inter-layer contract: bbox + conf + class,
progressively enriched by tracking (track_id), geometry (distance_m) and
speed estimation (speed_kmh), and by the task heads (mask, keypoints,
rbox) of the segment, pose and obb detectors.

``DetectionBatch`` is the struct-of-arrays form: fixed-capacity arrays
with a validity mask. Conversion to and from the list-of-``Detection``
surface happens only at the host boundary.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

# COCO class names, index == class id (YOLOv8's label space). Kept here so the
# detector needs no external name table (reference resolves names through the
# ultralytics model object, src/detect/yolo_ultralytics.py:24,51).
COCO_NAMES: Sequence[str] = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)


@dataclass
class Detection:
    """One detected object (reference: src/detect/types.py:4-15)."""

    x1: float
    y1: float
    x2: float
    y2: float
    conf: float
    cls_id: int
    cls_name: str
    track_id: Optional[int] = None
    distance_m: Optional[float] = None
    speed_kmh: Optional[float] = None
    # segment task only: instance mask at prototype resolution
    # (input/4), float32 in [0,1]; paste to frame pixels with
    # ops.masks.paste_masks. None for the detect task.
    mask: Optional[np.ndarray] = None
    # pose task only: (17, 3) COCO keypoints — x, y in SOURCE-frame
    # pixels, sigmoid visibility. None for other tasks.
    keypoints: Optional[np.ndarray] = None
    # obb task only: (5,) rotated box — cx, cy, w, h in SOURCE-frame
    # pixels, θ radians; x1y1x2y2 then hold the enclosing AABB.
    rbox: Optional[np.ndarray] = None


# a task head's Detection field → the DetectionBatch field that carries it
BATCH_FIELD = {"mask": "masks", "keypoints": "keypoints", "rbox": "rboxes"}


@dataclass
class DetectionBatch:
    """Fixed-capacity struct-of-arrays detection set (per frame).

    All arrays share leading shape ``(..., N)`` where ``N`` is the static
    capacity (== detect.max_det). Invalid slots are masked out by ``valid``.
    ``track_id`` uses 0 for "no id" (real ids start at 1, matching the
    reference's id assignment, src/track/sort_tracker.py:180,269);
    ``distance_m`` / ``speed_kmh`` use NaN for "not available".
    """

    boxes: np.ndarray        # (..., N, 4) float32 xyxy
    conf: np.ndarray         # (..., N) float32
    cls_id: np.ndarray       # (..., N) int32
    valid: np.ndarray        # (..., N) bool
    track_id: np.ndarray = None  # (..., N) int32, 0 == unassigned
    distance_m: np.ndarray = None  # (..., N) float32, NaN == unavailable
    speed_kmh: np.ndarray = None   # (..., N) float32, NaN == unavailable
    # segment task only: (..., N, mh, mw) float32 prototype-resolution
    # instance masks (None for the detect task — no auto-allocation)
    masks: np.ndarray = None
    # pose task only: (..., N, 17, 3) source-frame keypoints
    keypoints: np.ndarray = None
    # obb task only: (..., N, 5) source-frame rotated boxes (cx, cy,
    # w, h, θ); ``boxes`` then hold the enclosing AABBs
    rboxes: np.ndarray = None

    def __post_init__(self):
        n = self.boxes.shape[:-1]
        if self.track_id is None:
            self.track_id = np.zeros(n, dtype=np.int32)
        if self.distance_m is None:
            self.distance_m = np.full(n, np.nan, dtype=np.float32)
        if self.speed_kmh is None:
            self.speed_kmh = np.full(n, np.nan, dtype=np.float32)

    @property
    def capacity(self) -> int:
        return int(self.boxes.shape[-2])

    @staticmethod
    def from_detections(dets: Sequence[Detection], capacity: int) -> "DetectionBatch":
        """Pack a Python detection list into fixed-capacity arrays."""
        n = min(len(dets), capacity)
        boxes = np.zeros((capacity, 4), np.float32)
        conf = np.zeros((capacity,), np.float32)
        cls_id = np.zeros((capacity,), np.int32)
        valid = np.zeros((capacity,), bool)
        track_id = np.zeros((capacity,), np.int32)
        distance = np.full((capacity,), np.nan, np.float32)
        speed = np.full((capacity,), np.nan, np.float32)
        for i, d in enumerate(dets[:n]):
            boxes[i] = (d.x1, d.y1, d.x2, d.y2)
            conf[i] = d.conf
            cls_id[i] = d.cls_id
            valid[i] = True
            track_id[i] = 0 if d.track_id is None else int(d.track_id)
            if d.distance_m is not None:
                distance[i] = d.distance_m
            if d.speed_kmh is not None:
                speed[i] = d.speed_kmh
        return DetectionBatch(boxes, conf, cls_id, valid, track_id, distance, speed)

    def to_detections(self, names: Sequence[str] = COCO_NAMES) -> List[Detection]:
        """Unpack one frame's arrays back into the Python surface."""
        out: List[Detection] = []
        boxes = np.asarray(self.boxes)
        conf = np.asarray(self.conf)
        cls_id = np.asarray(self.cls_id)
        valid = np.asarray(self.valid)
        track_id = np.asarray(self.track_id)
        distance = np.asarray(self.distance_m)
        speed = np.asarray(self.speed_kmh)
        if boxes.ndim != 2:
            raise ValueError("to_detections expects a single frame (N,4) batch")
        masks = None if self.masks is None else np.asarray(self.masks)
        kpts = None if self.keypoints is None \
            else np.asarray(self.keypoints)
        rbs = None if self.rboxes is None else np.asarray(self.rboxes)
        for i in range(boxes.shape[0]):
            if not valid[i]:
                continue
            k = int(cls_id[i])
            name = names[k] if 0 <= k < len(names) else str(k)
            out.append(Detection(
                float(boxes[i, 0]), float(boxes[i, 1]),
                float(boxes[i, 2]), float(boxes[i, 3]),
                float(conf[i]), k, name,
                track_id=(int(track_id[i]) if track_id[i] > 0 else None),
                distance_m=(float(distance[i]) if np.isfinite(distance[i]) else None),
                speed_kmh=(float(speed[i]) if np.isfinite(speed[i]) else None),
                mask=(masks[i] if masks is not None else None),
                keypoints=(kpts[i] if kpts is not None else None),
                rbox=(rbs[i] if rbs is not None else None),
            ))
        return out
