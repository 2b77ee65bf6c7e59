from .cache import enable_compilation_cache
from .device import resolve_device
from .logging import get_logger
from .resolutions import RES_WIDTH, res_width
from .timing import StageTimer

__all__ = ["resolve_device", "StageTimer", "get_logger",
           "enable_compilation_cache", "RES_WIDTH", "res_width"]
