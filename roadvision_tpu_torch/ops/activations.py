"""Activations shared by the float and the int8 layers."""
from __future__ import annotations

import math

import torch

_GELU_2C = 2.0 * math.sqrt(2.0 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh approximation 0.5·x·(1 + tanh z), written
    as x·σ(2z), which keeps its relative accuracy where 1 + tanh z
    cancels (x below about -5), so that float64 evaluations on two
    devices round to the same float32."""
    return x * torch.sigmoid(_GELU_2C * (x + 0.044715 * x * x * x))
