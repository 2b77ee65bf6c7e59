"""Detector interface — a copy of ``roadvision_tpu/detect/base.py``."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List

import numpy as np

from .types import Detection


class Detector(ABC):
    @abstractmethod
    def infer(self, bgr: np.ndarray) -> List[Detection]:
        """BGR uint8 (H, W, 3) → detection list."""
        raise NotImplementedError

    def close(self) -> None:
        """Release resources."""
