"""roadvision_tpu_torch — the PyTorch/CUDA port of roadvision_tpu.

The default realtime pipeline (BGR→YCrCb, CLAHE on luma, YCrCb→BGR,
3×3 median, rect letterbox, YOLOv8, class-aware NMS, SORT, homography
distance/speed) runs on an NVIDIA Hopper card, with hand-written CUDA
kernels for the CLAHE tile-LUT build, the CLAHE LUT apply and the median
(``roadvision_tpu_torch/csrc``). Every kernel has a plain PyTorch version
beside it, which is what a tensor on the CPU runs.

Entry points default to ``device="cuda"`` and raise when no card is
present; pass ``device="cpu"`` to run the plain path.

The package imports ``torch`` and numpy only; it keeps its own copies of
the host-side pieces of ``roadvision_tpu`` it needs, each naming the file
it mirrors.
"""

__version__ = "0.1.0"
