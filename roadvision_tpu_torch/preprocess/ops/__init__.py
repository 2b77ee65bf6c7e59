from .clahe_dehaze import CLAHEDehaze
from .median_derain import MedianDerain

__all__ = ["CLAHEDehaze", "MedianDerain"]
