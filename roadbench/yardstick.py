"""The yardstick's arithmetic: the card's published peaks, the least
time of a kernel from the bytes and operations its shapes need, a
stage's device time from a CUDA graph of it alone, and the FLOPs of a
detector's forward counted from its layers' shapes.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the full 700 W. The
kernel bounds follow ``chip_smoke.py::bound``: bytes read once and
written once over the memory rate, or scalar operations over the
float32 rate outside the tensor cores, whichever is longer.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

# scalar operations per element, as the kernels compute them
K1_OPS_PER_PIXEL, K1_OPS_PER_BIN = 1, 14   # count; clip, scan, scale
K2_OPS_PER_PIXEL = 14                       # converts, 6 mul, 3 add, round
K3_OPS_PER_PIXEL = 28                       # the 3×3 median network
K7_OPS_PER_CHANNEL_POINT, K7_OPS_PER_POINT, K7_OPS_PER_LOGIT = 10, 40, 8


def bound_s(nbytes: float, nops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, nops / SCALAR_OPS_PER_S)


def clahe_tile_luts_s(planes: int, h: int, w: int, grid: int = 8) -> float:
    """K1 over ``planes`` luma planes: the (padded) planes read, the LUTs
    written."""
    hp, wp = (h, w) if h % grid == 0 and w % grid == 0 else \
        (h + grid - h % grid, w + grid - w % grid)
    pixels, bins = planes * hp * wp, planes * grid * grid * 256
    return bound_s(pixels + bins, K1_OPS_PER_PIXEL * pixels
                   + K1_OPS_PER_BIN * bins)


def clahe_apply_s(planes: int, h: int, w: int, grid: int = 8) -> float:
    """K2: planes read and written, the LUTs and the row and column
    tables read."""
    pixels = planes * h * w
    return bound_s(2 * pixels + planes * grid * grid * 256 + 20 * (h + w),
                   K2_OPS_PER_PIXEL * pixels)


def median_k_s(planes: int, h: int, w: int) -> float:
    """K3 (3×3): planes read and written."""
    pixels = planes * h * w
    return bound_s(2 * pixels, K3_OPS_PER_PIXEL * pixels)


def deform_sample_s(frames: int, nq: int, rows: float, nh: int = 8,
                    nl: int = 3, ndp: int = 4, dh: int = 32) -> float:
    """K7 over ``frames`` frames: offsets, logits and boxes read and the
    output written (f32), and the ``rows`` distinct value rows its
    corners touch read whole (f32 rows, rounded to bf16 in the kernel)."""
    small = frames * nq * (nh * nl * ndp * 2 + nh * nl * ndp + 4 + nh * dh)
    nbytes = 4 * small + rows * dh * 4
    nops = frames * nq * nh * nl * ndp * (dh * K7_OPS_PER_CHANNEL_POINT
                                          + K7_OPS_PER_POINT
                                          + K7_OPS_PER_LOGIT)
    return bound_s(nbytes, nops)


def graph_ms(fn: Callable, args: Sequence[torch.Tensor],
             reps: int = 10) -> float:
    """Device ms of ``fn(*args)`` captured alone in a CUDA graph: two
    warm-up calls on a side stream, the capture, one replay, then
    ``reps`` replays between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode():
        with torch.cuda.stream(side):
            for _ in range(2):
                fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn(*args)
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / reps


def forward_flops(model: dict, h: int, w: int, checkpoint: str) -> int:
    """FLOPs (2 × multiply-adds) of one frame's detector forward at an
    (h, w) input, counted from the layers' shapes (convolutions, linears,
    attention products) on the ``meta`` device."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference import rtdetr, yolov8
    from .reference.params import load_npz
    meta = torch.device("meta")
    p = load_npz(checkpoint, meta)
    x = torch.empty((1, h, w, 3), device=meta)
    with FlopCounterMode(display=False) as counter:
        if model["family"] == "yolov8":
            yolov8.forward(x, p)
        else:
            rtdetr.forward(x, p, int(model["num_queries"]))
    return int(counter.get_total_flops())
