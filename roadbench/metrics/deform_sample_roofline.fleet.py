"""deform_sample_roofline.fleet: K7's bound over its device time in the
traced stretch, %."""
from roadbench.readers import deform_sample_roofline as read  # noqa: F401
