"""Preprocess op registry — the port of
``roadvision_tpu/preprocess/registry.py``: the reference's names and its
CUDA-prefixed aliases resolve to the same classes; unknown names raise
``KeyError`` listing what is available."""
from __future__ import annotations

from typing import Dict, Type

from .base import PreprocessOp
from .ops import CLAHEDehaze, MedianDerain

REGISTRY: Dict[str, Type[PreprocessOp]] = {
    "CLAHEDehaze": CLAHEDehaze,
    "MedianDerain": MedianDerain,
    "CUDACLAHEDehaze": CLAHEDehaze,
    "CUDAMedianDerain": MedianDerain,
}


def register(name: str, cls: Type[PreprocessOp]) -> None:
    """Register a custom op class under ``name`` (the plugin point)."""
    REGISTRY[name] = cls


def get_op_class(name: str) -> Type[PreprocessOp]:
    if name not in REGISTRY:
        raise KeyError(
            f"Preprocess op '{name}' not found. Available: "
            f"{list(REGISTRY.keys())}")
    return REGISTRY[name]
