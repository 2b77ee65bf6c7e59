"""Device selection: the card by default, the CPU only when asked for."""
from __future__ import annotations

from typing import Dict, List, Optional, Union

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


def visible_devices(n_devices: Optional[int] = None,
                    device: DeviceLike = None) -> List[torch.device]:
    """``n_devices`` cards, every visible card when None; with
    ``device="cpu"``, that many entries of the CPU (one when None). More
    cards than are visible is a ``ValueError``: the list never shrinks
    and never moves to the CPU on its own."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (1 if n_devices is None else int(n_devices))
    visible = torch.cuda.device_count()
    n = visible if n_devices is None else int(n_devices)
    if not 1 <= n <= visible:
        raise ValueError(f"{n_devices} devices asked for: {visible} card(s) "
                         f"visible")
    return [torch.device("cuda", i) for i in range(n)]


_constants: Dict[tuple, torch.Tensor] = {}


def device_constant(values, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and shared: a CUDA graph cannot be captured
    around a copy from host memory, so what a captured step reads as a
    constant is uploaded before the capture. Callers never write it."""
    device = torch.device(device)
    key = (repr(values), dtype, str(device))
    got = _constants.get(key)
    if got is None:
        got = torch.tensor(values, dtype=dtype, device=device)
        _constants[key] = got
    return got
