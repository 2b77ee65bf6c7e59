"""Detector registry — the port of ``roadvision_tpu/detect/registry.py``.

"ultralytics" (the reference's name), "jax", "yolov8" and "torch" all
resolve to :class:`YOLOTorch`, the YOLOv8 detect backend. The backends
and model families the JAX package has and the port has not yet ("onnx",
RT-DETR; YOLOv5, YOLO11 and the task heads inside ``YOLOTorch``) raise
``NotImplementedError`` by name; an unknown backend is a ``ValueError``,
as in the JAX package.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np

from ..utils.device import DeviceLike
from .base import Detector

BACKENDS = ("ultralytics", "jax", "yolov8", "torch")


def _is_rtdetr(model: str) -> bool:
    """By name, or by content for an exported .npz (top keys
    ``Lbackbone…``), so a renamed RT-DETR file is still recognised."""
    if "rtdetr" in model.lower():
        return True
    p = Path(model)
    if p.suffix != ".npz" or not p.exists():
        return False
    with np.load(p) as z:
        return any(k.startswith("Lbackbone") for k in z.files)


def build_detector(cfg: Dict[str, Any], device: DeviceLike = None,
                   seed: int = 0) -> Detector:
    backend = (cfg.get("backend") or "ultralytics").lower()
    if backend in BACKENDS:
        if _is_rtdetr(str(cfg.get("model", ""))):
            raise NotImplementedError(
                "RT-DETR is not ported to roadvision_tpu_torch yet")
        from .yolo_torch import YOLOTorch
        return YOLOTorch(cfg, device=device, seed=seed)
    if backend == "onnx":
        raise NotImplementedError(
            "detect.backend 'onnx' is not ported to roadvision_tpu_torch yet")
    if backend == "tensorrt":
        raise ValueError(
            "detect.backend 'tensorrt' is not provided; use backend "
            "'ultralytics' (alias 'torch'), which runs the PyTorch model")
    raise ValueError(f"unknown detect backend: {backend}")
