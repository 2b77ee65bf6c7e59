"""idle_share.fleet: the device's idle share of the traced stretch, %
(moves fleet_fps)."""
from roadbench.readers import idle_share as read  # noqa: F401
