"""idle_share.cams: the device's idle share of the traced stretch, % (moves
frame_latency_p95_ms)."""
from roadbench.readers import idle_share as read  # noqa: F401
