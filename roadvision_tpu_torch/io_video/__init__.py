from .capture import Frame, ImageDirSource, NpyVideoSource, \
    SyntheticRoadSource, VideoSource
from .fps_meter import FPSMeter
from .mjpeg_avi import MJPEGAviReader
from .synthetic_device import DeviceSyntheticSource
from .writer import (EventGatedWriter, MJPEGAVIWriter, NpyWriter,
                     make_writer)
from .y4m import Y4MReader, Y4MWriter

__all__ = ["Frame", "VideoSource", "SyntheticRoadSource", "NpyVideoSource",
           "ImageDirSource", "FPSMeter", "MJPEGAVIWriter", "MJPEGAviReader",
           "NpyWriter", "make_writer", "EventGatedWriter", "Y4MReader",
           "Y4MWriter", "DeviceSyntheticSource"]
