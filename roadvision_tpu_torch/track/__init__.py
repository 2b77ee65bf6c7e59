from .base import Tracker
from .postprocess import interpolate_gaps
from .registry import build_device_step, build_tracker
from .sort import (SortOutput, SortState, greedy_associate, init_state,
                   iou_matrix, make_sort_step, nsa_r_scale, state_from_jax)
from .sort_tracker import SortTracker

__all__ = ["SortOutput", "SortState", "SortTracker", "Tracker",
           "build_device_step", "build_tracker", "greedy_associate",
           "init_state", "interpolate_gaps", "iou_matrix", "make_sort_step",
           "nsa_r_scale", "state_from_jax"]
