from . import weights, yolov8
from .yolov8 import REG_MAX, STRIDES, arch_spec, decode

__all__ = ["yolov8", "weights", "arch_spec", "decode", "STRIDES",
           "REG_MAX"]
