"""Checkpoint reading and the plain layers both reference models use."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def load_npz(path: str, device: torch.device) -> Params:
    """A flat ``L``-prefixed checkpoint → float32 tensors on ``device``,
    keyed without the prefix: conv kernels HWIO → OIHW, linear weights
    kept (in, out). On the ``meta`` device only the shapes are made."""
    out: Params = {}
    with np.load(path) as z:
        for key in z.files:
            arr = z[key]
            if arr.ndim == 4:
                shape = (arr.shape[3], arr.shape[2], arr.shape[0],
                         arr.shape[1])
            else:
                shape = arr.shape
            if device.type == "meta":
                out[key[1:]] = torch.empty(shape, device=device)
                continue
            t = torch.from_numpy(arr.astype(np.float32))
            if arr.ndim == 4:
                t = t.permute(3, 2, 0, 1)
            out[key[1:]] = t.contiguous().to(device)
    return out


def conv(x: torch.Tensor, p: Params, name: str, stride: int = 1,
         pad=None, act=None) -> torch.Tensor:
    """Conv with bias; groups from the input width over the kernel's;
    ``act`` None, "silu" or "relu"."""
    w = p[f"{name}.w"]
    k = w.shape[-1]
    y = F.conv2d(x, w, p[f"{name}.b"], stride, k // 2 if pad is None else pad,
                 1, x.shape[1] // w.shape[1])
    if act == "silu":
        return F.silu(y)
    if act == "relu":
        return F.relu(y)
    return y


def linear(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    return x @ p[f"{name}.w"] + p[f"{name}.b"]


def layer_norm(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.g"], p[f"{name}.b"],
                        1e-5)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))
