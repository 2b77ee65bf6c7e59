from . import yolo

__all__ = ["yolo"]
