"""dispatch_idle_ms.fleet: device idle in the traced stretch from the gaps that
begin inside the program's `dispatch` spans, ms a fleet batch (moves
fleet_fps)."""
from roadbench.program import dispatch_idle_ms as read  # noqa: F401
