"""detector_ms.fleet: resize, forward and NMS or top-k alone on a fleet
batch, device ms."""
from roadbench.readers import detector_ms as read  # noqa: F401
