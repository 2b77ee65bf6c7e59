"""Preprocess pipeline — the port of ``roadvision_tpu/preprocess/pipeline.py``
(the fused planar chain, pipeline.py:241-255).

Built from ``cfg.chain = [{name, params}, ...]`` through the registry; a
disabled or empty chain is the identity; ops fold left to right on uint8
(b, g, r) planes with one unpack and one repack.

Not ported yet, and raising at construction: the low-contrast auto-gate
(``auto_gate.enable_low_contrast_gate``), ``contrast_thresh: "auto"`` and
``impulse_thresh``. The sampled terminal-op path is refused by the
engine (``tpu.sampled_preprocess``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .registry import get_op_class


class PreprocessPipeline:
    def __init__(self, config: Dict[str, Any]):
        self.enabled = bool(config.get("enabled", True))
        self.chain_cfg = config.get("chain", []) or []
        gate = config.get("auto_gate", {}) or {}
        if gate.get("enable_low_contrast_gate", False):
            raise NotImplementedError(
                "preprocess.auto_gate.enable_low_contrast_gate is not ported "
                "to roadvision_tpu_torch yet")
        if gate.get("contrast_thresh", 20.0) == "auto":
            raise NotImplementedError(
                "preprocess.auto_gate.contrast_thresh: 'auto' is not ported "
                "to roadvision_tpu_torch yet")
        if gate.get("impulse_thresh") or None:
            raise NotImplementedError(
                "preprocess.auto_gate.impulse_thresh is not ported to "
                "roadvision_tpu_torch yet")
        self.ops = [get_op_class(node.get("name"))(
            **(node.get("params", {}) or {})) for node in self.chain_cfg]

    @property
    def identity(self) -> bool:
        return not self.enabled or not self.ops

    def apply_batch(self, frames: torch.Tensor) -> torch.Tensor:
        """(..., H, W, 3) uint8 BGR → processed uint8 batch, same shape."""
        if self.identity:
            return frames
        planes = tuple(frames[..., c] for c in range(3))
        for op in self.ops:
            planes = op.apply_planar(planes)
        return torch.stack([p.to(torch.uint8) for p in planes], dim=-1)
