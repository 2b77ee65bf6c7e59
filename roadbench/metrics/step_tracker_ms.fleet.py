"""step_tracker_ms.fleet: the tracker tail with its geometry inside the fleet
step, on live tracks, between marks 2 and 3, device ms a fleet batch
(moves fleet_fps)."""
from roadbench.program import step_tracker_ms as read  # noqa: F401
