from .sort import (SortOutput, SortState, build_sort_step, greedy_associate,
                   init_state, iou_matrix, make_sort_step)

__all__ = ["SortOutput", "SortState", "build_sort_step", "greedy_associate",
           "init_state", "iou_matrix", "make_sort_step"]
