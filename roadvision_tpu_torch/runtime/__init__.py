from .engine import FrameResult, PipelineEngine, unpack_detections
from .multi_engine import MultiStreamEngine, build_sources

__all__ = ["FrameResult", "MultiStreamEngine", "PipelineEngine",
           "build_sources", "unpack_detections"]
