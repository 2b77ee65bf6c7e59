from .base import Tracker
from .botsort import BotSortTracker, make_botsort_step
from .bytetrack import ByteTracker, make_byte_step
from .deepsort import DeepSortTracker
from .ocsort import OcSortTracker
from .postprocess import interpolate_gaps
from .registry import BACKENDS, build_device_step, build_tracker
from .sort import (SortOutput, SortState, auction_associate, bbox_to_z,
                   greedy_associate, init_state, iou_matrix, make_sort_scan,
                   make_sort_step, nsa_r_scale, scan_steps, state_from_jax,
                   x_to_bbox)
from .sort_tracker import SortTracker

__all__ = ["BACKENDS", "BotSortTracker", "ByteTracker", "DeepSortTracker",
           "OcSortTracker", "SortOutput", "SortState", "SortTracker",
           "Tracker", "auction_associate", "bbox_to_z", "build_device_step",
           "build_tracker", "greedy_associate", "init_state",
           "interpolate_gaps", "iou_matrix", "make_botsort_step",
           "make_byte_step", "make_sort_scan", "make_sort_step",
           "nsa_r_scale", "scan_steps", "state_from_jax", "x_to_bbox"]
