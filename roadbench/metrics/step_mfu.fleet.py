"""step_mfu.fleet: the fleet step's detector FLOPs a second over the bf16
peak, %."""
from roadbench.readers import step_mfu as read  # noqa: F401
