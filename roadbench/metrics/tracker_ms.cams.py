"""tracker_ms.cams: the stacked tracker step and geometry alone on a fleet
batch, device ms (moves frame_latency_p95_ms)."""
from roadbench.readers import tracker_ms as read  # noqa: F401
