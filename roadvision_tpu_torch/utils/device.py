"""Device selection: the card by default, the CPU only when asked for."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None``/"cuda"/"auto" → the CUDA device; "cpu" → the CPU.

    Raises when a CUDA device is asked for and none is present: the port
    never falls back to the CPU on its own.
    """
    if device is None or str(device) == "auto":
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev
