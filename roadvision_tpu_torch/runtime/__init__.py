from .engine import FrameResult, PipelineEngine, unpack_detections

__all__ = ["FrameResult", "PipelineEngine", "unpack_detections"]
