"""Tracker interface — a copy of ``roadvision_tpu/track/base.py``."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Iterable, List, Optional

from ..detect.types import Detection
from ..geometry import HomographyProjector


class Tracker(ABC):
    @abstractmethod
    def update(self, detections: Iterable[Detection], timestamp: float,
               projector: Optional[HomographyProjector] = None
               ) -> List[Detection]:
        """Update and return detections enriched with ID/distance/speed."""

    def close(self) -> None:
        """Release resources."""
