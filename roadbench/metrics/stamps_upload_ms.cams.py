"""stamps_upload_ms.cams: the engine's host span `stamps` in the open loop,
ms a batch (moves frame_latency_p95_ms)."""
from roadbench.program import stamps_upload_ms as read  # noqa: F401
