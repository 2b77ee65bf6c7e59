"""YOLO weights for the port — a numpy copy of
``roadvision_tpu/models/yolo/weights.py`` and the mapping between its
parameter tree and the port's modules.

  * checkpoint import, as in the JAX package: ultralytics state dicts
    (``.pt`` via :func:`_load_torch`, which tries
    ``torch.load(weights_only=True)`` first; an ``.npz`` of torch names;
    an ``.onnx`` export read by models/yolo/onnx_io.py) → the nested
    parameter tree of numpy arrays, conv + BatchNorm fused (eps 1e-3),
    OIHW → HWIO — for YOLOv8, YOLO11, YOLOv5 and the seg / pose / obb /
    cls heads; the repo's own ``.npz`` (:func:`import_npz`,
    :func:`export_npz`);
  * :func:`load_params` — the JAX contract (weights.py:347-440):
    ``(params, arch, size, loaded)``; a missing file, an unreadable ONNX
    or a key mismatch runs a seeded random init (pose nc 1, obb nc 15)
    unless ``allow_random=False``;
  * :func:`params_from_jax` / :func:`tree_from_model` — tree ↔ state
    dict (HWIO ↔ OIHW), RT-DETR's trees and modules included
    (models/rtdetr.py); :func:`describe` reads (arch, task, size, nc)
    off a YOLO tree; :func:`model_from_params` and :func:`random_model`
    build the ``nn.Module``.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_CONV_LAYERS = ("0", "1", "3", "5", "7", "16", "19")
_C2F_LAYERS = ("2", "4", "6", "8", "12", "15", "18", "21")
_C11_CONV_LAYERS = ("0", "1", "3", "5", "7", "17", "20")
_C11_C3K2_LAYERS = ("2", "4", "6", "8", "13", "16", "19", "22")
_V5_CONV_LAYERS = ("0", "1", "3", "5", "7", "10", "14", "18", "21")
_V5_C3_LAYERS = ("2", "4", "6", "8", "13", "17", "20", "23")
_SIZE_BY_C0 = {16: "n", 32: "s", 48: "m", 64: "l", 80: "x"}
BN_EPS = 1e-3
HEAD_KEY = {"v8": "22", "11": "23", "v5": "24"}


def _to_np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _fuse(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """Fuse ``{prefix}.conv`` + ``{prefix}.bn`` into HWIO weight + bias
    (float64 arithmetic, stored float32, as the JAX function)."""
    w = _to_np(sd[f"{prefix}.conv.weight"]).astype(np.float64)  # OIHW
    if f"{prefix}.bn.weight" in sd:
        gamma = _to_np(sd[f"{prefix}.bn.weight"]).astype(np.float64)
        beta = _to_np(sd[f"{prefix}.bn.bias"]).astype(np.float64)
        mean = _to_np(sd[f"{prefix}.bn.running_mean"]).astype(np.float64)
        var = _to_np(sd[f"{prefix}.bn.running_var"]).astype(np.float64)
        scale = gamma / np.sqrt(var + BN_EPS)
        w = w * scale[:, None, None, None]
        b = beta - mean * scale
    elif f"{prefix}.conv.bias" in sd:
        b = _to_np(sd[f"{prefix}.conv.bias"]).astype(np.float64)
    else:
        b = np.zeros(w.shape[0], np.float64)
    return {"w": w.transpose(2, 3, 1, 0).astype(np.float32),
            "b": b.astype(np.float32)}


def _plain(sd: Mapping[str, Any], wkey: str, bkey: str):
    w = _to_np(sd[wkey]).astype(np.float32)
    b = (_to_np(sd[bkey]).astype(np.float32) if bkey in sd
         else np.zeros(w.shape[0], np.float32))
    return {"w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)), "b": b}


def _blocks(sd, prefix: str) -> list:
    """The ``{prefix}.{j}`` bottlenecks, j = 0, 1, … while present."""
    out, j = [], 0
    while f"{prefix}.{j}.cv1.conv.weight" in sd:
        out.append({n: _fuse(sd, f"{prefix}.{j}.{n}")
                    for n in ("cv1", "cv2")})
        j += 1
    return out


def _c2f(sd, i: str) -> Dict[str, Any]:
    return {"cv1": _fuse(sd, f"{i}.cv1"), "cv2": _fuse(sd, f"{i}.cv2"),
            "m": _blocks(sd, f"{i}.m")}


def _normalize_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip ``model.`` / ``module.`` / ``_orig_mod.`` prefixes."""
    out = {}
    for k, v in sd.items():
        kk = k
        while not re.match(r"^\d+\.", kk):
            if "." not in kk:
                break
            head, kk = kk.split(".", 1)
            if head not in ("model", "module", "_orig_mod"):
                kk = k
                break
        out[kk] = v
    return out


def _branch3(sd, prefix: str) -> list:
    return [_fuse(sd, f"{prefix}.0"), _fuse(sd, f"{prefix}.1"),
            _plain(sd, f"{prefix}.2.weight", f"{prefix}.2.bias")]


def state_dict_to_params(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """An ultralytics YOLOv8 detection state dict → the parameter tree."""
    sd = _normalize_keys(sd)
    p: Dict[str, Any] = {i: _fuse(sd, i) for i in _CONV_LAYERS}
    p.update({i: _c2f(sd, i) for i in _C2F_LAYERS})
    p["9"] = {"cv1": _fuse(sd, "9.cv1"), "cv2": _fuse(sd, "9.cv2")}
    p["22"] = {"cv2": [_branch3(sd, f"22.cv2.{lvl}") for lvl in range(3)],
               "cv3": [_branch3(sd, f"22.cv3.{lvl}") for lvl in range(3)]}
    return p


def _base_loader(arch: str):
    return (state_dict_to_params_11, "23") if arch == "11" \
        else (state_dict_to_params, "22")


def _cv4_branch(sd: Mapping[str, Any], head: str = "22") -> list:
    """The shared 3-conv cv4 side branch (pose / obb / seg)."""
    return [_branch3(sd, f"{head}.cv4.{lvl}") for lvl in range(3)]


def state_dict_to_params_seg(sd: Mapping[str, Any],
                             arch: str = "v8") -> Dict[str, Any]:
    """The detection mapping plus ``cv4`` and ``proto``; the transposed
    convolution's weight arrives (in, out, kH, kW) and is stored HWIO."""
    base, head = _base_loader(arch)
    p = base(sd)
    sd = _normalize_keys(sd)
    p[head]["cv4"] = _cv4_branch(sd, head)
    up_w = _to_np(sd[f"{head}.proto.upsample.weight"]).astype(np.float32)
    up_b = (_to_np(sd[f"{head}.proto.upsample.bias"]).astype(np.float32)
            if f"{head}.proto.upsample.bias" in sd
            else np.zeros(up_w.shape[1], np.float32))
    p[head]["proto"] = {
        "cv1": _fuse(sd, f"{head}.proto.cv1"),
        "up_w": np.ascontiguousarray(up_w.transpose(2, 3, 0, 1)),
        "up_b": up_b,
        "cv2": _fuse(sd, f"{head}.proto.cv2"),
        "cv3": _fuse(sd, f"{head}.proto.cv3"),
    }
    return p


def detect_task(sd: Mapping[str, Any]) -> str:
    """"segment" | "pose" | "obb" (cv4 final width 1) | "classify" |
    "detect", read off the state dict's keys."""
    sd = _normalize_keys(sd)
    head = "23" if any(k.startswith("23.cv2.") for k in sd) else "22"
    if any(k.startswith(f"{head}.proto.") for k in sd):
        return "segment"
    if f"{head}.cv4.0.2.weight" in sd:
        ne = _to_np(sd[f"{head}.cv4.0.2.weight"]).shape[0]
        return "obb" if ne == 1 else "pose"
    if "9.linear.weight" in sd or "10.linear.weight" in sd:
        return "classify"
    return "detect"


def state_dict_to_params_pose(sd: Mapping[str, Any],
                              arch: str = "v8") -> Dict[str, Any]:
    base, head = _base_loader(arch)
    p = base(sd)
    p[head]["cv4"] = _cv4_branch(_normalize_keys(sd), head)
    return p


state_dict_to_params_obb = state_dict_to_params_pose


def state_dict_to_params_cls(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A YOLOv8-cls state dict → the tree (layers 0-8 + Classify at 9)."""
    sd = _normalize_keys(sd)
    p: Dict[str, Any] = {i: _fuse(sd, i) for i in ("0", "1", "3", "5", "7")}
    p.update({i: _c2f(sd, i) for i in ("2", "4", "6", "8")})
    lw = _to_np(sd["9.linear.weight"]).astype(np.float32)   # (nc, 1280)
    lb = (_to_np(sd["9.linear.bias"]).astype(np.float32)
          if "9.linear.bias" in sd else np.zeros(lw.shape[0], np.float32))
    p["9"] = {"conv": _fuse(sd, "9.conv"),
              "lin_w": np.ascontiguousarray(lw.T), "lin_b": lb}
    return p


def detect_arch(sd: Mapping[str, Any]) -> str:
    """"v8" (Detect at 22) | "v5" (anchored, 24) | "11" (Detect at 23)."""
    sd = _normalize_keys(sd)
    if any(k.startswith("24.m.") for k in sd):
        return "v5"
    if any(k.startswith("23.cv2.") for k in sd):
        return "11"
    return "v8"


def infer_size_from_state_dict(sd: Mapping[str, Any]) -> str:
    """Model size from the stem width (and YOLO11's depth for m / l)."""
    sd = _normalize_keys(sd)
    c0 = int(_to_np(sd["0.conv.weight"]).shape[0])
    if detect_arch(sd) == "11":
        if c0 == 64:
            return "l" if "2.m.1.cv1.conv.weight" in sd else "m"
        return {16: "n", 32: "s", 96: "x"}[c0]
    return _SIZE_BY_C0[c0]


def _c3k2_import(sd, i: str) -> Dict[str, Any]:
    """C3k2: the C2f shell whose ``m`` entries are Bottlenecks or C3k."""
    out = {"cv1": _fuse(sd, f"{i}.cv1"), "cv2": _fuse(sd, f"{i}.cv2"),
           "m": []}
    j = 0
    while f"{i}.m.{j}.cv1.conv.weight" in sd:
        pre = f"{i}.m.{j}"
        if f"{pre}.cv3.conv.weight" in sd:                 # C3k
            blk = {n: _fuse(sd, f"{pre}.{n}") for n in ("cv1", "cv2", "cv3")}
            blk["m"] = _blocks(sd, f"{pre}.m")
        else:                                              # Bottleneck
            blk = {n: _fuse(sd, f"{pre}.{n}") for n in ("cv1", "cv2")}
        out["m"].append(blk)
        j += 1
    return out


def state_dict_to_params_11(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A YOLO11 detection state dict → the tree; depthwise kernels stay
    (k, k, 1, C)."""
    sd = _normalize_keys(sd)
    p: Dict[str, Any] = {i: _fuse(sd, i) for i in _C11_CONV_LAYERS}
    p.update({i: _c3k2_import(sd, i) for i in _C11_C3K2_LAYERS})
    p["9"] = {"cv1": _fuse(sd, "9.cv1"), "cv2": _fuse(sd, "9.cv2")}
    psa: Dict[str, Any] = {"cv1": _fuse(sd, "10.cv1"),
                           "cv2": _fuse(sd, "10.cv2"), "m": []}
    j = 0
    while f"10.m.{j}.attn.qkv.conv.weight" in sd:
        psa["m"].append({
            "attn": {n: _fuse(sd, f"10.m.{j}.attn.{n}")
                     for n in ("qkv", "proj", "pe")},
            "ffn": [_fuse(sd, f"10.m.{j}.ffn.0"),
                    _fuse(sd, f"10.m.{j}.ffn.1")]})
        j += 1
    p["10"] = psa
    det: Dict[str, Any] = {"cv2": [], "cv3": []}
    for lvl in range(3):
        det["cv2"].append(_branch3(sd, f"23.cv2.{lvl}"))
        det["cv3"].append([
            {"dw": _fuse(sd, f"23.cv3.{lvl}.0.0"),
             "pw": _fuse(sd, f"23.cv3.{lvl}.0.1")},
            {"dw": _fuse(sd, f"23.cv3.{lvl}.1.0"),
             "pw": _fuse(sd, f"23.cv3.{lvl}.1.1")},
            _plain(sd, f"23.cv3.{lvl}.2.weight", f"23.cv3.{lvl}.2.bias")])
    p["23"] = det
    return p


def state_dict_to_params_v5(sd: Mapping[str, Any]) -> Dict[str, Any]:
    sd = _normalize_keys(sd)
    p: Dict[str, Any] = {i: _fuse(sd, i) for i in _V5_CONV_LAYERS}
    for i in _V5_C3_LAYERS:
        p[i] = {n: _fuse(sd, f"{i}.{n}") for n in ("cv1", "cv2", "cv3")}
        p[i]["m"] = _blocks(sd, f"{i}.m")
    p["9"] = {"cv1": _fuse(sd, "9.cv1"), "cv2": _fuse(sd, "9.cv2")}
    p["24"] = {"m": [_plain(sd, f"24.m.{lvl}.weight", f"24.m.{lvl}.bias")
                     for lvl in range(3)]}
    return p


def load_params(path_or_sd, size: str = "n", nc: int = 80,
                allow_random: bool = True, arch: str = "v8",
                task: str = "detect", seed: int = 0):
    """Load a checkpoint; fall back to a seeded random init.

    Returns (params, arch ("v8" | "v5" | "11"), size, loaded), as the JAX
    function does. The checkpoint overrides the arch / size hints; its
    head says the task (``"cv4"`` / ``"proto"`` in the head's subtree).
    Random init follows ``arch`` and ``task``, with nc 1 for pose and 15
    for obb when nc is left at 80.
    """
    sd = None
    if isinstance(path_or_sd, Mapping) and path_or_sd:
        sd = path_or_sd
    elif isinstance(path_or_sd, (str, Path)):
        p = Path(path_or_sd)
        if p.exists():
            if p.suffix == ".onnx":
                from .onnx_io import load_onnx
                try:
                    sd = load_onnx(p)
                except ValueError as exc:
                    if not allow_random:
                        raise
                    print(f"[roadvision] unreadable ONNX ({exc}); "
                          f"using random init")
            elif p.suffix == ".npz":
                with np.load(p) as z:
                    raw = {k: z[k] for k in z.files}
                if raw and all(k.startswith("L") for k in raw):
                    params = import_npz(p)       # the repo's own tree
                    arch, _, size, _ = describe(params)
                    return params, arch, size, True
                sd = raw
            else:
                sd = _load_torch(p)
    if sd is not None:
        try:
            arch = detect_arch(sd)
            size = infer_size_from_state_dict(sd)
            if arch == "v5":
                params = state_dict_to_params_v5(sd)
            else:
                found = detect_task(sd)
                if found == "detect":
                    params = (state_dict_to_params_11(sd) if arch == "11"
                              else state_dict_to_params(sd))
                else:
                    loaders = {"segment": state_dict_to_params_seg,
                               "pose": state_dict_to_params_pose,
                               "obb": state_dict_to_params_obb}
                    params = loaders[found](sd, arch=arch)
            return params, arch, size, True
        except KeyError as exc:
            if not allow_random:
                raise
            print(f"[roadvision] checkpoint key mismatch ({exc}); "
                  f"using random init")
    if not allow_random:
        raise FileNotFoundError(f"cannot load weights from {path_or_sd}")
    if arch == "v5":
        task = "detect"
    elif task == "pose" and nc == 80:
        nc = 1
    elif task == "obb" and nc == 80:
        nc = 15
    if task not in ("segment", "pose", "obb"):
        task = "detect"
    return tree_from_model(random_model(arch, task, size, nc, seed)), \
        arch, size, False


def _load_torch(path: Path):
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        try:
            obj = torch.load(path, map_location="cpu", weights_only=False)
        except Exception as exc:
            print(f"[roadvision] failed to load {path}: {exc}")
            return None
    if isinstance(obj, dict) and "model" in obj and hasattr(obj["model"],
                                                            "state_dict"):
        return {k: v.float() for k, v in obj["model"].state_dict().items()}
    if isinstance(obj, dict) and all(hasattr(v, "shape")
                                     for v in obj.values()):
        return obj
    if hasattr(obj, "state_dict"):
        return obj.state_dict()
    return None


def export_npz(params, path) -> None:
    """The tree → an ``.npz`` with ``L``-prefixed top-level keys, so that
    on import every other all-digit level is restored to a list."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else f"L{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}")
        else:
            flat[prefix] = np.asarray(node)
    walk(params, "")
    np.savez(path, **flat)


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """{"2.m.0.cv1.w": a, …} → the nested tree; below the top level an
    all-digit, contiguous 0…n-1 dict was a list."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    def restore(tree):
        if not isinstance(tree, dict):
            return tree
        if tree and all(k.isdigit() for k in tree) \
                and sorted(int(k) for k in tree) == list(range(len(tree))):
            return [restore(tree[str(i)]) for i in range(len(tree))]
        return {k: restore(v) for k, v in tree.items()}

    return {k: restore(v) for k, v in root.items()}


def import_npz(path) -> Dict[str, Any]:
    """Flat ``L``-prefixed .npz → nested tree (float16 storage → float32)."""
    with np.load(path) as z:
        flat = {k[1:]: (z[k].astype(np.float32) if z[k].dtype == np.float16
                        else z[k]) for k in z.files}
    return unflatten_tree(flat)


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


# tree leaf ↔ state-dict name and layout: conv kernels HWIO ↔ OIHW, the
# transposed convolution's HWIO ↔ (I, O, kH, kW); the rest as they are
_LEAF_TO_TORCH = {"w": ("weight", (3, 2, 0, 1)), "b": ("bias", None),
                  "up_w": ("up_w", (2, 3, 0, 1))}
_LEAF_FROM_TORCH = {"weight": ("w", (2, 3, 1, 0)), "bias": ("b", None),
                    "up_w": ("up_w", (2, 3, 0, 1))}


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """A tree in the JAX package's layout (numpy, or anything
    ``np.asarray`` takes) → the port's state dict, ``layers.``-prefixed;
    an RT-DETR tree (top keys backbone / enc / dec) → RT-DETR's
    (models/rtdetr.py)."""
    if "backbone" in tree:
        from ..rtdetr import params_from_tree
        return params_from_tree(tree)
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in flatten_tree(tree).items():
        stem, leaf = key.rsplit(".", 1)
        name, perm = _LEAF_TO_TORCH.get(leaf, (leaf, None))
        arr = np.asarray(arr, dtype=np.float32)
        if perm is not None:
            arr = arr.transpose(perm)
        sd[f"layers.{stem}.{name}"] = torch.from_numpy(np.array(arr,
                                                                order="C"))
    return sd


def tree_from_model(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a float model's state dict
    → the JAX-layout tree of float32 numpy arrays."""
    return tree_from_state_dict(model.state_dict())


def tree_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Tensors keyed by the port's parameter names (a state dict, its
    gradients, an optimiser's moments) → the JAX-layout tree of float32
    numpy arrays; RT-DETR's names (``backbone.…``) go through
    ``rtdetr.tree_from_state_dict``."""
    if any(k.startswith("backbone.") for k in sd):
        from ..rtdetr import tree_from_state_dict as rtdetr_tree
        return rtdetr_tree(sd)
    flat = {}
    for key, t in sd.items():
        stem, leaf = key[len("layers."):].rsplit(".", 1)
        name, perm = _LEAF_FROM_TORCH.get(leaf, (leaf, None))
        arr = t.detach().float().cpu().numpy()
        flat[f"{stem}.{name}"] = np.ascontiguousarray(
            arr.transpose(perm) if perm is not None else arr)
    return unflatten_tree(flat)


def describe(tree) -> Tuple[str, str, str, int]:
    """(arch, task, size, nc) of a parameter tree."""
    c0 = int(np.asarray(tree["0"]["w"]).shape[-1])
    if "lin_w" in tree.get("9", {}):
        return "v8", "classify", _SIZE_BY_C0[c0], \
            int(np.asarray(tree["9"]["lin_b"]).shape[0])
    if "24" in tree:
        no = int(np.asarray(tree["24"]["m"][0]["b"]).shape[0])
        return "v5", "detect", _SIZE_BY_C0[c0], no // 3 - 5
    arch = "11" if "23" in tree else "v8"
    if arch == "11":
        size = ("l" if len(tree["2"]["m"]) > 1 else "m") if c0 == 64 \
            else {16: "n", 32: "s", 96: "x"}[c0]
    else:
        size = _SIZE_BY_C0[c0]
    head = tree[HEAD_KEY[arch]]
    task = "detect"
    if "proto" in head:
        task = "segment"
    elif "cv4" in head:
        task = "obb" if np.asarray(head["cv4"][0][2]["b"]).shape[0] == 1 \
            else "pose"
    return arch, task, size, int(np.asarray(head["cv3"][0][2]["b"]).shape[0])


def new_model(arch: str, task: str, size: str, nc: int) -> torch.nn.Module:
    """The module for one family / task / size, weights not set."""
    if task == "classify":
        from .yolov8_cls import YOLOv8Cls
        return YOLOv8Cls(size, nc)
    if arch == "v5":
        from .yolov5 import YOLOv5
        return YOLOv5(size, nc)
    if arch == "11":
        from .yolo11 import YOLO11
        model = YOLO11(size, nc)
    else:
        from .yolov8 import YOLOv8
        model = YOLOv8(size, nc)
    if task == "segment":
        from .yolov8_seg import attach_seg
        attach_seg(model)
    elif task == "pose":
        from .yolov8_pose import attach_pose
        attach_pose(model)
    elif task == "obb":
        from .yolov8_obb import attach_obb
        attach_obb(model)
    return model


def random_model(arch: str, task: str, size: str, nc: int,
                 seed: int = 0) -> torch.nn.Module:
    """Seeded random init by the JAX package's recipe (He-normal convs,
    zero biases, the family's head biases); the numbers differ from
    ``jax.random``'s."""
    from .yolov8 import he_normal_
    model = new_model(arch, task, size, nc)
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        he_normal_(model, gen)
        if task == "classify":
            from .yolov8_cls import init_cls_
            init_cls_(model, gen)
        elif arch == "v5":
            from .yolov5 import head_bias_
            head_bias_(model.layers["24"], nc)
        else:
            from .yolov8 import head_bias_
            head_bias_(model.layers[model.head_key], nc)
            if task == "segment":
                from .yolov8_seg import init_seg_
                init_seg_(model, gen)
    return model


def model_from_params(tree) -> torch.nn.Module:
    """The module a tree describes, with the tree's weights (RT-DETR's
    too)."""
    if "backbone" in tree:
        from ..rtdetr import model_from_params as rtdetr_model
        return rtdetr_model(tree)
    model = new_model(*describe(tree))
    model.load_state_dict(params_from_jax(tree))
    return model
