from .base import Tracker
from .botsort import BotSortTracker
from .bytetrack import ByteTracker
from .deepsort import DeepSortTracker
from .ocsort import OcSortTracker
from .postprocess import interpolate_gaps
from .registry import BACKENDS, build_device_step, build_tracker
from .sort import (SortOutput, SortState, auction_associate, greedy_associate,
                   init_state, iou_matrix, make_sort_step, nsa_r_scale,
                   state_from_jax)
from .sort_tracker import SortTracker

__all__ = ["BACKENDS", "BotSortTracker", "ByteTracker", "DeepSortTracker",
           "OcSortTracker", "SortOutput", "SortState", "SortTracker",
           "Tracker", "auction_associate", "build_device_step",
           "build_tracker", "greedy_associate", "init_state",
           "interpolate_gaps", "iou_matrix", "make_sort_step", "nsa_r_scale",
           "state_from_jax"]
