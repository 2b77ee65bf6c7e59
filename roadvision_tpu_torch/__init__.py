"""roadvision_tpu_torch — the PyTorch/CUDA port of roadvision_tpu.

The default realtime pipeline (BGR→YCrCb, CLAHE on luma, YCrCb→BGR,
3×3 median, rect letterbox, YOLOv8, class-aware NMS, SORT, homography
distance/speed) runs on an NVIDIA Hopper card; the detector also runs
YOLOv5 and YOLO11, the segment / pose / obb heads (and a classifier),
int8, test-time augmentation and tiling, from ``.npz``, ``.pt`` or
``.onnx`` weights. Hand-written CUDA
kernels for the CLAHE tile-LUT build, the CLAHE LUT apply and the median
(``roadvision_tpu_torch/csrc``). Every kernel has a plain PyTorch version
beside it, which is what a tensor on the CPU runs.

Around the engine: ``Pipeline`` (the library API), frame sources and
recorders (``io_video``), overlays (``vis``), the camera fleet
(``runtime.MultiStreamEngine``: several streams batched on a card),
traffic analytics (``analytics``), and the entry points under
``roadvision_tpu_torch.tools`` (preview, serve, detect, track, bench,
analyze).

Entry points default to ``device="cuda"`` and raise when no card is
present; pass ``device="cpu"`` (``--device cpu``) to run the plain path.

The package imports ``torch``, numpy, the standard library, PyYAML and
PIL (and ``cv2`` where it is installed); it keeps its own copies of the
host-side pieces of ``roadvision_tpu`` it needs, each naming the file it
mirrors.
"""

__version__ = "0.1.0"

from .config import DEFAULTS, load_config  # noqa: F401
from .detect.types import Detection  # noqa: F401


def __getattr__(name):
    # Pipeline pulls in the whole engine stack; lazy, so that
    # ``import roadvision_tpu_torch`` stays light for config-only users
    if name == "Pipeline":
        from .api import Pipeline
        return Pipeline
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
