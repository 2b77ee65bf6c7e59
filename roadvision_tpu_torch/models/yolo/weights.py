"""YOLOv8 weights for the port — numpy-only copies of the repo's own
``.npz`` format (``roadvision_tpu/models/yolo/weights.py:463-511``) and
the mapping from the JAX parameter tree to the module's state dict.

  * :func:`import_npz` — the nested parameter tree of numpy arrays, the
    same tree ``weights.import_npz`` builds (float16 storage → float32);
  * :func:`params_from_jax` — a JAX-layout tree (numpy or anything
    ``np.asarray`` takes) → ``YOLOv8`` state dict, HWIO → OIHW;
  * :func:`load_params` — a checkpoint path, or seeded random init when
    the file is absent.

Only the v8 detect family is ported: ``.pt``/ONNX import, YOLOv5,
YOLO11 and the seg/pose/obb heads raise ``NotImplementedError``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SIZE_BY_C0 = {16: "n", 32: "s", 48: "m", 64: "l", 80: "x"}


def import_npz(path) -> Dict[str, Any]:
    """Flat ``L``-prefixed .npz → nested parameter tree (numpy arrays)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if val.dtype == np.float16:
            val = val.astype(np.float32)
        node[parts[-1]] = val

    def restore(tree):
        if not isinstance(tree, dict):
            return tree
        if tree and all(k.isdigit() for k in tree) \
                and sorted(int(k) for k in tree) == list(range(len(tree))):
            return [restore(tree[str(i)]) for i in range(len(tree))]
        return {k: restore(v) for k, v in tree.items()}

    return {k[1:]: restore(v) for k, v in root.items()}


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list tree → {"2.m.0.cv1.w": array, ...}."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: np.asarray(tree)}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX parameter tree → ``YOLOv8`` state dict (HWIO → OIHW)."""
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in flatten_tree(tree).items():
        arr = np.asarray(arr, dtype=np.float32)
        stem, leaf = key.rsplit(".", 1)
        if leaf == "w":
            sd[f"layers.{stem}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif leaf == "b":
            sd[f"layers.{stem}.bias"] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"unexpected parameter leaf {key!r}")
    return sd


def describe(tree) -> Tuple[str, int]:
    """(size, nc) of a v8 detect tree; raises for what is not ported."""
    if "24" in tree:
        raise NotImplementedError("YOLOv5 checkpoints are not ported to "
                                  "roadvision_tpu_torch yet")
    if "23" in tree:
        raise NotImplementedError("YOLO11 checkpoints are not ported to "
                                  "roadvision_tpu_torch yet")
    if "cv4" in tree.get("22", {}) or "proto" in tree.get("22", {}):
        raise NotImplementedError("seg/pose/obb heads are not ported to "
                                  "roadvision_tpu_torch yet")
    c0 = int(np.asarray(tree["0"]["w"]).shape[-1])
    nc = int(np.asarray(tree["22"]["cv3"][0][2]["b"]).shape[0])
    return _SIZE_BY_C0[c0], nc


def load_params(path, size: str = "n", nc: int = 80
                ) -> Tuple[Optional[Dict[str, Any]], str, int, bool]:
    """(tree or None, size, nc, loaded). A missing file means random
    init (tree None), as in the JAX package; an existing file must be
    the repo's own .npz format."""
    p = Path(str(path))
    if not p.exists():
        return None, size, nc, False
    if p.suffix != ".npz":
        raise NotImplementedError(
            f"{p.suffix or 'this'} checkpoints are not ported to "
            f"roadvision_tpu_torch yet (the repo's own .npz format only)")
    with np.load(p) as z:
        keys = list(z.files)
    if not keys or not all(k.startswith("L") for k in keys):
        raise NotImplementedError(
            f"{p} is not in the repo's exported .npz layout")
    tree = import_npz(p)
    size, nc = describe(tree)
    return tree, size, nc, True
