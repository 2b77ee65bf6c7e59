"""preprocess_ms.fleet: the preprocess chain alone on a fleet batch, device
ms."""
from roadbench.readers import preprocess_ms as read  # noqa: F401
