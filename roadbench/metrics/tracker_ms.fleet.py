"""tracker_ms.fleet: the stacked tracker scan and geometry alone on a fleet
batch, device ms (moves fleet_fps)."""
from roadbench.readers import tracker_ms as read  # noqa: F401
