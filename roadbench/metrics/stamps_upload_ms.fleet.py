"""stamps_upload_ms.fleet: the engine's host span `stamps` (the stamps'
rebase and copy to the card), ms a fleet batch (moves fleet_fps)."""
from roadbench.program import stamps_upload_ms as read  # noqa: F401
