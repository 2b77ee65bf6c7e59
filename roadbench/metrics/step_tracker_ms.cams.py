"""step_tracker_ms.cams: the one-frame tracker step with its geometry inside
the open loop's fleet step, between marks 2 and 3, device ms a batch
(moves frame_latency_p95_ms)."""
from roadbench.program import step_tracker_ms as read  # noqa: F401
