"""Detector registry — the port of ``roadvision_tpu/detect/registry.py``.

"ultralytics" (the reference's name), "jax", "yolov8", "torch" and
"onnx" resolve to :class:`YOLOTorch`. "onnx" reads the configured
``.onnx`` export's weight initializers (models/yolo/onnx_io.py, no
onnxruntime) into the same PyTorch model, and fails fast unless
``detect.model`` names an existing ``.onnx`` file. RT-DETR models (by
name, or an exported ``.npz`` whose keys start ``Lbackbone``) resolve to
:class:`RTDETRTorch`. "tensorrt" is a ``ValueError``, an unknown backend
too, as in the JAX package.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

from ..models.rtdetr import is_rtdetr_npz
from ..utils.device import DeviceLike
from .base import Detector

BACKENDS = ("ultralytics", "jax", "yolov8", "torch", "onnx")


def _is_rtdetr(model: str) -> bool:
    """By name, or by content for an exported .npz (top keys
    ``Lbackbone…``), so a renamed RT-DETR file is still recognised."""
    return "rtdetr" in model.lower() or is_rtdetr_npz(model)


def build_detector(cfg: Dict[str, Any], device: DeviceLike = None,
                   seed: int = 0) -> Detector:
    backend = (cfg.get("backend") or "ultralytics").lower()
    if backend in BACKENDS:
        model = str(cfg.get("model", ""))
        if backend == "onnx":
            if not model.endswith(".onnx"):
                raise ValueError(
                    f"detect.backend 'onnx' needs detect.model to be a "
                    f".onnx file (got {model!r})")
            if not Path(model).exists():
                # an explicitly configured interchange file: fail fast
                # rather than run random-init weights
                raise FileNotFoundError(
                    f"detect.backend 'onnx': model file not found: {model}")
        if _is_rtdetr(model):
            # the ultralytics wrapper's other detector family, by name
            from .rtdetr_torch import RTDETRTorch
            return RTDETRTorch(cfg, device=device, seed=seed)
        from .yolo_torch import YOLOTorch
        return YOLOTorch(cfg, device=device, seed=seed)
    if backend == "tensorrt":
        raise ValueError(
            "detect.backend 'tensorrt' is not provided: the port runs the "
            "PyTorch model (cuDNN convolutions, hand-written CUDA kernels "
            "for the preprocess chain); use backend 'ultralytics' (alias "
            "'torch'), or 'onnx' to load an .onnx export's weights")
    raise ValueError(f"unknown detect backend: {backend}")
