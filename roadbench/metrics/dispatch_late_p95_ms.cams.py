"""dispatch_late_p95_ms.cams: how late the open-loop generator dispatched,
95th percentile, ms."""
from roadbench.readers import dispatch_late_p95_ms as read  # noqa: F401
