"""step_preprocess_ms.fleet: preprocess's device time inside the fleet step as
it runs, between the step's marks 0 and 1, ms a fleet batch (moves
fleet_fps)."""
from roadbench.program import step_preprocess_ms as read  # noqa: F401
