from .base import Detector
from .registry import build_detector
from .types import COCO_NAMES, Detection, DetectionBatch

__all__ = ["COCO_NAMES", "Detection", "DetectionBatch", "Detector",
           "build_detector"]
