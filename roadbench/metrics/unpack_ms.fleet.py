"""unpack_ms.fleet: the engine's host unpack a fleet batch, ms (moves
fleet_fps)."""
from roadbench.readers import unpack_ms as read  # noqa: F401
