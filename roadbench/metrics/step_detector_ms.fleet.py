"""step_detector_ms.fleet: the detector's whole pass inside the fleet step,
NMS or top-k included, between marks 1 and 2, device ms a fleet batch
(moves fleet_fps)."""
from roadbench.program import step_detector_ms as read  # noqa: F401
