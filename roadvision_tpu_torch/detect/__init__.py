from .types import COCO_NAMES, Detection

__all__ = ["COCO_NAMES", "Detection"]
