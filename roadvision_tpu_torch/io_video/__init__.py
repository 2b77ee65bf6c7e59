from .capture import Frame, SyntheticRoadSource, VideoSource

__all__ = ["Frame", "SyntheticRoadSource", "VideoSource"]
