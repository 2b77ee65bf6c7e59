"""Detection data contract — a copy of ``roadvision_tpu/detect/types.py``
(``Detection`` and ``COCO_NAMES``; the task-head fields wait for the
ports of those heads)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

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
    """One detected object: box, score, class, and the track id,
    ground distance and speed that tracking and geometry add."""

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
