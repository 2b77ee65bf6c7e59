"""clahe_tile_luts_roofline.fleet: K1's bound over its device time in the
traced stretch, %."""
from roadbench.readers import clahe_tile_luts_roofline as read  # noqa: F401
