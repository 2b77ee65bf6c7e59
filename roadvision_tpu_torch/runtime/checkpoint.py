"""Training-state checkpoints — the port of
``roadvision_tpu/runtime/checkpoint.py``.

The file is the JAX package's ``.npz`` (``weights.export_npz``):
``{"P": params, "M": optimiser state, "meta": {"step"}}`` with every
array in the JAX layout (HWIO convolutions, ``(in, out)`` linears), so a
state saved by either package resumes in the other. The optimiser state
is the SGD momentum (a tree shaped like the parameters) or RT-DETR's
AdamW ``{"m", "v", "t"}``. An orbax checkpoint directory cannot be read
without JAX: :func:`load_train_state` raises ``ValueError`` there.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch

from ..models.yolo import weights as yolo_weights

OptState = Union[Dict[str, torch.Tensor], Dict[str, Any]]


def _is_adamw(state: Mapping) -> bool:
    return set(state) == {"m", "v", "t"}


def opt_state_tree(state: OptState) -> Dict[str, Any]:
    """The port's optimiser state (tensors keyed by parameter name) → the
    JAX package's tree."""
    if _is_adamw(state):
        return {"m": yolo_weights.tree_from_state_dict(state["m"]),
                "v": yolo_weights.tree_from_state_dict(state["v"]),
                "t": np.asarray(state["t"].cpu().numpy(), np.int32)}
    return yolo_weights.tree_from_state_dict(state)


def opt_state_from_tree(tree: Mapping, device: torch.device) -> OptState:
    """A JAX optimiser-state tree → the port's, on ``device``."""
    def named(t):
        return {k: v.to(device) for k, v in
                yolo_weights.params_from_jax(t).items()}
    if _is_adamw(tree):
        return {"m": named(tree["m"]), "v": named(tree["v"]),
                "t": torch.as_tensor(np.asarray(tree["t"]),
                                     dtype=torch.int32, device=device)}
    return named(tree)


def _npz_path(path) -> Path:
    p = Path(path)
    return p if p.suffix == ".npz" else p.with_suffix(".npz")


def save_train_state(path, model: torch.nn.Module, opt_state: OptState,
                     step: int) -> str:
    """``save_train_state`` :27 (its ``.npz`` branch); returns the path
    written."""
    p = _npz_path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    yolo_weights.export_npz({"P": yolo_weights.tree_from_model(model),
                             "M": opt_state_tree(opt_state),
                             "meta": {"step": np.asarray(step)}}, p)
    return str(p)


def load_train_state(path) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """``load_train_state`` :46 → (params tree, optimiser-state tree,
    step), host numpy in the JAX layout."""
    p = Path(path)
    if p.is_dir():
        raise ValueError(
            f"{p} is an orbax checkpoint directory, which cannot be read "
            f"without JAX; save the training state as .npz "
            f"(tools/train.py --out run.npz) to resume it here")
    tree = yolo_weights.import_npz(_npz_path(p))
    return tree["P"], tree["M"], int(np.asarray(tree["meta"]["step"]))
