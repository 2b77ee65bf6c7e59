"""YOLO detector backend for the port — the counterpart of
``roadvision_tpu/detect/yolo_jax.py``: YOLOv8, YOLO11 and YOLOv5, the
detect / segment / pose / obb tasks, float32, bfloat16 and int8,
test-time augmentation and tiling.

Config surface as in the JAX package: ``model``, ``task`` ("auto" reads
the model name's ``-seg`` / ``-pose`` / ``-obb``, then the checkpoint's
head), ``conf_thres``, ``iou_thres``, ``max_det``, ``classes_keep``,
``imgsz``, ``rect``, ``compute_dtype`` ("bfloat16" | "int8" | anything
else float32; the CPU runs float32 unless int8), ``int8_calibration``
(static activation scales from the first N frames), ``tiling``
(``enable``, ``tile``, ``overlap``, ``full_frame``; detect task only) and
``tta`` (detect task only, exclusive with tiling, imgsz a multiple of
32). Weights come from ``.npz`` / ``.pt`` / ``.onnx`` checkpoints
(models/yolo/weights.py); a missing file runs a seeded random init.

The surface the engine composes its step from: ``letterbox``,
``forward`` (the model's raw outputs), ``candidates`` (the forwards of
one batch, TTA's and the tiles' included) and ``postprocess`` (NMS and
the task's side output, in source pixels); ``run`` is the two together.
Host API: ``infer_batch``, ``infer``, ``calibrate_int8``, ``set_params``,
``last_letterbox_meta``, ``close``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.yolo import quant
from ..models.yolo import weights as yolo_weights
from ..ops.letterbox import (letterbox_meta, letterbox_rect_u8, letterbox_u8,
                             scale_boxes)
from ..ops.nms import nms_batch
from ..utils.device import DeviceLike, device_constant, resolve_device
from .base import Detector
from .types import BATCH_FIELD, COCO_NAMES, Detection, DetectionBatch

_TASK_SUFFIX = {"segment": "-seg", "pose": "-pose", "obb": "-obb"}


def _size_from_model_name(name: str) -> str:
    base = str(name).lower()
    for v in ("yolov8", "yolov5", "yolo11"):
        for s in ("n", "s", "m", "l", "x"):
            if f"{v}{s}" in base:
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
        self.int8 = compute == "int8"
        self.dtype = torch.bfloat16 if compute == "bfloat16" \
            and self.device.type == "cuda" else torch.float32

        model_ref = str(cfg.get("model", "yolov8n.pt"))
        name = model_ref.lower()
        arch_hint = "v5" if "yolov5" in name \
            else "11" if "yolo11" in name else "v8"
        task = str(cfg.get("task", "auto"))
        if task == "auto":
            task = next((t for t, sfx in _TASK_SUFFIX.items() if sfx in name),
                        "detect")
        params, self.arch, self.size, self.loaded = yolo_weights.load_params(
            model_ref, size=_size_from_model_name(model_ref), arch=arch_hint,
            task=task, seed=seed)
        # the checkpoint's head wins over the name and the config
        found = yolo_weights.describe(params)[1]
        self.task = task if found == "detect" else found
        # the Detection field that carries the task's side output
        self.extra_field: Optional[str] = {
            "segment": "mask", "pose": "keypoints", "obb": "rbox"}.get(
                self.task)
        if self.task in ("segment", "pose", "obb") and self.arch == "v5":
            raise ValueError(f"task '{self.task}' requires a YOLOv8 or "
                             f"YOLO11 {self.task} model")
        if not self.loaded:
            print(f"[roadvision] weights '{model_ref}' not found — running "
                  f"yolo{self.arch}{self.size}"
                  f"{_TASK_SUFFIX.get(self.task, '')} with random init "
                  f"(seed {seed})")
        self.params = params
        self.model = self._place(yolo_weights.model_from_params(params))
        self.nc = self.model.nc
        self._set_names()
        # int8_calibration: N > 0 calibrates static activation scales
        # from the first N frames (running abs-max), then bakes them
        self._calib_left = int(cfg.get("int8_calibration", 0)) \
            if self.int8 else 0

        tcfg = cfg.get("tiling") or {}
        self.tile_cfg: Optional[Dict[str, Any]] = None
        if tcfg.get("enable"):
            if self.task != "detect":
                raise ValueError(
                    f"detect.tiling supports the detect task only (got "
                    f"'{self.task}') — per-anchor side outputs have no "
                    f"defined cross-tile merge")
            self.tile_cfg = dict(
                tile=int(tcfg.get("tile", self.imgsz)),
                overlap=float(tcfg.get("overlap", 0.25)),
                full_frame=bool(tcfg.get("full_frame", True)))
        self.tta = bool(cfg.get("tta", False))
        if self.tta and self.task != "detect":
            raise ValueError(f"detect.tta supports the detect task only "
                             f"(got '{self.task}') — the augmented "
                             f"candidate merge is box/score-level")
        if self.tta and self.tile_cfg:
            raise ValueError("detect.tta and detect.tiling are mutually "
                             "exclusive (both multiply the candidate set)")
        if self.tta and self.imgsz % 32 != 0:
            raise ValueError(
                f"detect.tta needs detect.imgsz to be a multiple of 32 "
                f"(got {self.imgsz}): the augmented-pass anchor trim is "
                f"level-aligned only on stride-32 canvases")
        self._last_lb_meta = None

    def _place(self, model):
        """Compute dtype (or int8), device, eval mode; channels-last on
        the card for the float paths."""
        if self.int8:
            quant.quantize_model_(model)
        else:
            model.set_compute_dtype(self.dtype)
        model = model.to(self.device).eval()
        if self.device.type == "cuda" and not self.int8:
            model = model.to(memory_format=torch.channels_last)
        return model

    def _set_names(self) -> None:
        self.names = {i: n for i, n in enumerate(COCO_NAMES)} \
            if self.nc == len(COCO_NAMES) \
            else {i: str(i) for i in range(self.nc)}
        if self.task == "pose" and self.nc == 1:
            self.names = {0: "person"}   # -pose checkpoints are person-only
        if self.task == "obb" and self.nc == 15:
            from ..models.yolo.yolov8_obb import DOTA_NAMES
            self.names = dict(enumerate(DOTA_NAMES))

    def set_params(self, params) -> None:
        """Swap the weights without rebuilding the detector. ``params``
        is a tree in the JAX package's layout (``weights.import_npz``,
        ``load_params``, ``YOLOJax.params``) of this detector's family,
        task and size; the class count follows the tree. The class count
        is read from the family's own head (22, 23 or 24)."""
        arch, task, size, nc = yolo_weights.describe(params)
        if (arch, task, size) != (self.arch, self.task, self.size):
            raise ValueError(
                f"set_params: a yolo{arch}{size} tree ({task}) for a "
                f"yolo{self.arch}{self.size} {self.task} detector")
        self.params = params
        self.model = self._place(yolo_weights.model_from_params(params))
        self.nc = nc
        self._set_names()

    # ------------------------------------------------------------------
    def letterbox(self, frames_u8: torch.Tensor):
        """The configured letterbox (rect or square)."""
        if self.rect:
            return letterbox_rect_u8(frames_u8, size=self.imgsz)
        return letterbox_u8(frames_u8, size=self.imgsz)

    @torch.inference_mode()
    def forward(self, imgs: torch.Tensor):
        """Letterboxed NHWC images → the model's outputs: (boxes (B, N, 4),
        scores (B, N, nc)), then coeffs and protos (segment) or keypoints
        (pose); obb gives (rboxes (B, N, 5), scores)."""
        return self.model(imgs)

    # ------------------------------------------------------------------
    def calibration_step(self, imgs: torch.Tensor) -> None:
        """``int8_calibration: N``: fold this batch into the running
        abs-max; after N frames bake the static scales. No-op otherwise."""
        if self._calib_left <= 0:
            return
        self._calib_collect(imgs)
        self._calib_left -= int(imgs.shape[0])
        if self._calib_left <= 0:
            self._calib_left = 0
            n = quant.finish_calibration(self.model)
            print(f"[roadvision] int8 auto-calibration baked static "
                  f"scales for {n} convs")

    @torch.inference_mode()
    def _calib_collect(self, imgs: torch.Tensor) -> None:
        if not any(m.observing for m in quant.qconvs(self.model)):
            quant.observe(self.model)
        self.model(imgs)

    def calibrate_int8(self, frames_u8, batch_size: int = 8) -> int:
        """Static per-conv activation scales from calibration frames
        ((N, H, W, 3) BGR uint8): the running abs-max over all batches.
        Returns the number of convs calibrated."""
        if not self.int8:
            raise RuntimeError("calibrate_int8 requires "
                               "detect.compute_dtype: 'int8'")
        frames = np.asarray(frames_u8)
        if frames.ndim == 3:
            frames = frames[None]
        quant.observe(self.model)
        for i in range(0, frames.shape[0], batch_size):
            x = torch.from_numpy(np.ascontiguousarray(
                frames[i:i + batch_size])).to(self.device)
            self._calib_collect(self.letterbox(x)[0])
        self._calib_left = 0     # a manual call supersedes the counter
        return quant.finish_calibration(self.model)

    # ------------------------------------------------------------------
    def candidates(self, frames_u8: torch.Tensor, lb=None):
        """(B, H, W, 3) uint8 frames on the device → (raw outputs, ratio,
        pad). ``lb`` is an (imgs, ratio, pad) letterbox already made
        (the engine's sampled path). The raw outputs are the model's, the
        three augmented passes' merged candidates under TTA, or under
        tiling candidates already in source pixels (ratio, pad None)."""
        if self.tile_cfg:
            from ..ops.tiling import tile_plan, tiled_candidates
            if self._calib_left > 0:
                self.calibration_step(self.letterbox(frames_u8)[0])
            plan = tile_plan(frames_u8.shape[1], frames_u8.shape[2],
                             tile=self.tile_cfg["tile"],
                             overlap=self.tile_cfg["overlap"])
            return tiled_candidates(self, frames_u8, plan,
                                    full_frame=self.tile_cfg["full_frame"]), \
                None, None
        imgs, ratio, pad = lb if lb is not None else self.letterbox(frames_u8)
        self.calibration_step(imgs)
        if self.tta:
            from ..ops.tta import tta_candidates
            return tta_candidates(self.forward, imgs), ratio, pad
        return self.forward(imgs), ratio, pad

    def postprocess(self, raw, ratio, pad, hw):
        """NMS and the task's side output → (boxes, conf, cls, valid,
        extra) in source pixels; ``extra`` is None (detect), masks
        (B, K, mh, mw) at prototype resolution, keypoints (B, K, 17, 3)
        or rboxes (B, K, 5), and boxes the rboxes' enclosing AABBs for
        obb."""
        h, w = hw
        kw = dict(conf_thres=self.conf, iou_thres=self.iou,
                  max_det=self.max_det, classes_keep=self.keep or None)
        if self.tile_cfg:
            return (*nms_batch(*raw, pre_topk=600, **kw), None)
        if self.task == "obb":
            from ..ops.obb import nms_rotated_batch, rbox_to_aabb, scale_rboxes
            rb, conf, cls_id, valid = nms_rotated_batch(*raw, pre_topk=300,
                                                        **kw)
            # the AABB of the already-scaled rboxes, clamped to the frame:
            # no second scale_boxes
            rb = scale_rboxes(rb, ratio, pad, hw)
            ab = rbox_to_aabb(rb)
            lim = device_constant([w, h, w, h], ab.dtype, ab.device)
            return torch.minimum(ab.clamp(min=0), lim), conf, cls_id, valid, rb
        if self.task not in ("segment", "pose"):
            b, c, k, v = nms_batch(*raw, pre_topk=600 if self.tta else 300,
                                   **kw)
            return scale_boxes(b, ratio, pad, hw), c, k, v, None
        b, c, k, v, idx = nms_batch(raw[0], raw[1], pre_topk=300,
                                    return_idx=True, **kw)
        idx = idx.long()
        if self.task == "segment":
            from ..ops.masks import compose_masks
            coeffs, protos = raw[2], raw[3]
            kc = torch.gather(coeffs, 1,
                              idx[..., None].expand(-1, -1, coeffs.shape[-1]))
            extra = compose_masks(kc, protos, b, v)   # canvas-space crop
        else:
            from ..models.yolo.yolov8_pose import scale_kpts
            kpts = raw[2]
            kk = torch.gather(kpts, 1, idx[..., None, None].expand(
                -1, -1, *kpts.shape[2:]))
            extra = scale_kpts(kk, ratio, pad, hw)
        return scale_boxes(b, ratio, pad, hw), c, k, v, extra

    @torch.inference_mode()
    def run(self, frames_u8: torch.Tensor, lb=None):
        """Device frames → (boxes, conf, cls, valid, extra), source pixels."""
        raw, ratio, pad = self.candidates(frames_u8, lb)
        return self.postprocess(raw, ratio, pad, tuple(frames_u8.shape[1:3]))

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def infer_batch(self, frames_u8: np.ndarray) -> DetectionBatch:
        """(B, H, W, 3) BGR uint8 → DetectionBatch with (B, max_det)
        arrays in source pixels, and the task's side output."""
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8)) \
            .to(self.device)
        h, w = frames.shape[1:3]
        boxes, conf, cls_id, valid, extra = self.run(frames)
        if self.task == "segment":
            self._last_lb_meta = letterbox_meta(h, w, size=self.imgsz,
                                                rect=self.rect)
        side = {BATCH_FIELD[self.extra_field]: extra.cpu().numpy()} \
            if self.extra_field else {}
        return DetectionBatch(*(t.cpu().numpy()
                                for t in (boxes, conf, cls_id, valid)),
                              **side)

    def infer(self, bgr: np.ndarray) -> List[Detection]:
        batch = self.infer_batch(np.asarray(bgr)[None])
        single = DetectionBatch(
            batch.boxes[0], batch.conf[0], batch.cls_id[0], batch.valid[0],
            masks=None if batch.masks is None else batch.masks[0],
            keypoints=None if batch.keypoints is None else batch.keypoints[0],
            rboxes=None if batch.rboxes is None else batch.rboxes[0])
        names = [self.names.get(i, str(i)) for i in range(self.nc)]
        return single.to_detections(names)

    def last_letterbox_meta(self):
        """(ratio, (left, top)) of the most recent segment-task batch, for
        ``ops.masks.paste_masks``."""
        return self._last_lb_meta

    def close(self) -> None:
        """Nothing is cached per shape; kept for the Detector contract."""
