"""YOLOv8 detector backend for the port — the counterpart of
``roadvision_tpu/detect/yolo_jax.py`` for the plain detect task of the
v8 family: the surface the engine composes its step from (``letterbox``,
``forward``, ``detect``) and the host API (``infer_batch``, ``infer``,
``set_params``, ``close``).

Config surface as in the JAX package: ``model``, ``conf_thres``,
``iou_thres``, ``max_det``, ``classes_keep``, ``imgsz``, ``rect``,
``compute_dtype`` ("bfloat16" | "float32"; the CPU always runs float32).
Weights come from the repo's own ``.npz`` checkpoints; a missing file
runs a seeded random init with nc = 80.

Not ported yet, and raising at construction: the seg/pose/obb tasks,
YOLOv5 and YOLO11, int8, test-time augmentation and tiling.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..models.yolo import weights as yolo_weights
from ..models.yolo.yolov8 import build_model
from ..ops.letterbox import letterbox_rect_u8, letterbox_u8, scale_boxes
from ..ops.nms import nms_batch
from ..utils.device import DeviceLike, resolve_device
from .base import Detector
from .types import COCO_NAMES, Detection, DetectionBatch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _size_from_model_name(name: str) -> str:
    base = str(name).lower()
    for s in ("n", "s", "m", "l", "x"):
        if f"yolov8{s}" in base:
            return s
    return "n"


class YOLOTorch(Detector):
    def __init__(self, cfg: Dict[str, Any], device: DeviceLike = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        self.conf = float(cfg.get("conf_thres", 0.25))
        self.iou = float(cfg.get("iou_thres", 0.7))
        self.max_det = int(cfg.get("max_det", 100))
        self.keep = tuple(sorted(int(x) for x in cfg.get("classes_keep", [])))
        self.imgsz = int(cfg.get("imgsz", 640))
        self.rect = bool(cfg.get("rect", True))
        compute = str(cfg.get("compute_dtype", "bfloat16"))
        if compute not in _DTYPES:
            raise NotImplementedError(
                f"detect.compute_dtype {compute!r} is not ported to "
                f"roadvision_tpu_torch yet (bfloat16 | float32)")
        self.dtype = _DTYPES[compute] if self.device.type == "cuda" \
            else torch.float32
        self.task = "detect"
        model_ref = str(cfg.get("model", "yolov8n.pt"))
        name = model_ref.lower()
        for marker, what in (("rtdetr", "RT-DETR"), ("yolov5", "YOLOv5"),
                             ("yolo11", "YOLO11"), ("-seg", "the segment task"),
                             ("-pose", "the pose task"),
                             ("-obb", "the obb task")):
            if marker in name:
                raise NotImplementedError(
                    f"{what} is not ported to roadvision_tpu_torch yet")
        task = str(cfg.get("task", "auto"))
        if task not in ("auto", "detect"):
            raise NotImplementedError(
                f"detect.task {task!r} is not ported to roadvision_tpu_torch "
                f"yet")
        if (cfg.get("tiling") or {}).get("enable"):
            raise NotImplementedError("detect.tiling is not ported to "
                                      "roadvision_tpu_torch yet")
        if cfg.get("tta", False):
            raise NotImplementedError("detect.tta is not ported to "
                                      "roadvision_tpu_torch yet")
        tree, self.size, self.nc, self.loaded = yolo_weights.load_params(
            model_ref, size=_size_from_model_name(model_ref), nc=80)
        if not self.loaded:
            print(f"[roadvision] weights '{model_ref}' not found — running "
                  f"yolov8{self.size} with random init (seed {seed})")
        self.model = self._place(
            build_model(tree, self.size, self.nc, seed=seed))
        self._set_names()

    def _place(self, model):
        """Compute dtype, device, eval mode, channels-last on the card."""
        model.set_compute_dtype(self.dtype)
        model = model.to(self.device).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        return model

    def _set_names(self) -> None:
        self.names = {i: n for i, n in enumerate(COCO_NAMES)} \
            if self.nc == len(COCO_NAMES) \
            else {i: str(i) for i in range(self.nc)}

    def set_params(self, params) -> None:
        """Swap the weights without rebuilding the detector. ``params``
        is a parameter tree in the JAX package's layout (as
        ``weights.import_npz`` or ``YOLOJax.params`` give it); the class
        count follows the tree, the model size must stay."""
        size, nc = yolo_weights.describe(params)
        if size != self.size:
            raise ValueError(f"set_params: a yolov8{size} tree for a "
                             f"yolov8{self.size} detector")
        if nc != self.nc:
            self.model, self.nc = self._place(build_model(params, size,
                                                          nc)), nc
            self._set_names()
        else:
            self.model.load_state_dict(yolo_weights.params_from_jax(params))

    def letterbox(self, frames_u8: torch.Tensor):
        """The configured letterbox (rect or square)."""
        if self.rect:
            return letterbox_rect_u8(frames_u8, size=self.imgsz)
        return letterbox_u8(frames_u8, size=self.imgsz)

    @torch.inference_mode()
    def forward(self, imgs: torch.Tensor):
        """Letterboxed NHWC images → (boxes (B, N, 4), scores (B, N, nc))."""
        return self.model(imgs)

    def detect(self, imgs: torch.Tensor):
        """Letterboxed images → NMS'd (boxes, conf, cls, valid) in canvas
        pixels, fixed shape (B, max_det)."""
        boxes, scores = self.forward(imgs)
        return nms_batch(boxes, scores, conf_thres=self.conf,
                         iou_thres=self.iou, max_det=self.max_det,
                         pre_topk=300,
                         classes_keep=self.keep if self.keep else None)

    @torch.inference_mode()
    def infer_batch(self, frames_u8: np.ndarray) -> DetectionBatch:
        """(B, H, W, 3) BGR uint8 → DetectionBatch with (B, max_det)
        arrays, boxes in source pixels."""
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8)) \
            .to(self.device)
        h, w = frames.shape[1:3]
        imgs, ratio, pad = self.letterbox(frames)
        boxes, conf, cls_id, valid = self.detect(imgs)
        boxes = scale_boxes(boxes, ratio, pad, (h, w))
        return DetectionBatch(*(t.cpu().numpy()
                                for t in (boxes, conf, cls_id, valid)))

    def infer(self, bgr: np.ndarray) -> List[Detection]:
        batch = self.infer_batch(np.asarray(bgr)[None])
        single = DetectionBatch(batch.boxes[0], batch.conf[0],
                                batch.cls_id[0], batch.valid[0])
        names = [self.names.get(i, str(i)) for i in range(self.nc)]
        return single.to_detections(names)

    def close(self) -> None:
        """Nothing is cached per shape; kept for the Detector contract."""
