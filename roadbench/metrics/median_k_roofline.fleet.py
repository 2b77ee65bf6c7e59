"""median_k_roofline.fleet: K3's bound over its device time in the traced
stretch, %."""
from roadbench.readers import median_k_roofline as read  # noqa: F401
