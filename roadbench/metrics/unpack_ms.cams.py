"""unpack_ms.cams: the engine's host unpack a fleet batch, ms (moves
frame_latency_p95_ms)."""
from roadbench.readers import unpack_ms as read  # noqa: F401
