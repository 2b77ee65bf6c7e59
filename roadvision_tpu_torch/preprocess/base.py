"""Preprocess op contract — the port of ``roadvision_tpu/preprocess/base.py``.

Ops take ``**params`` at construction. The slice ports the planar path
only: :meth:`PreprocessOp.apply_planar` maps (b, g, r) uint8 planes of a
frame batch to new planes, and the pipeline fuses the chain around one
unpack and one repack.
"""
from __future__ import annotations

from typing import Any


class PreprocessOp:
    """Base class: ``apply_planar((b, g, r)) -> (b, g, r)`` on uint8 planes."""

    def __init__(self, **params: Any):
        self.params = params

    def apply_planar(self, planes):
        raise NotImplementedError(
            f"{type(self).__name__} has no planar path")
