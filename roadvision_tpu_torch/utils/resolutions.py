"""Canonical height→width mapping for the standard bench resolutions —
a copy of ``roadvision_tpu/utils/resolutions.py``. One shared table, so
that a warm-up and the bench dispatch the same shapes.
"""
from __future__ import annotations

# 1080p/720p are 16:9 broadcast; 480 follows the bench's 640x480 (VGA)
# convention rather than 854x480, matching bench.py's workload shapes.
RES_WIDTH = {1080: 1920, 720: 1280, 480: 640, 360: 640}


def res_width(height: int) -> int:
    """Width for a standard bench height; 16:9 for anything unlisted."""
    return RES_WIDTH.get(int(height), int(height) * 16 // 9)
