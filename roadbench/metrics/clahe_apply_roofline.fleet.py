"""clahe_apply_roofline.fleet: K2's bound over its device time in the
traced stretch, %."""
from roadbench.readers import clahe_apply_roofline as read  # noqa: F401
