"""RT-DETR detector backend for the port — the counterpart of
``roadvision_tpu/detect/rtdetr_jax.py`` (NMS-free set prediction).

The ``Detector`` surface of the YOLO backend with RT-DETR's predict
conventions: a stretch resize to (imgsz, imgsz) (no letterbox, so ratio
and pad are the identity), normalised xyxy boxes and per-class sigmoid
probabilities for ``num_queries`` decoded proposals, then score
threshold → ``classes_keep`` → top-``max_det`` (``select_topk_batch``,
no IoU pass; ``iou_thres`` is accepted and ignored), × (w, h) and the
frame clip.

Config as ``RTDETRJax``: ``num_queries`` (default max(100, max_det) of
the published 300; 1…300 and at least ``max_det``), ``decoder_layers``
(1…6), ``compute_dtype`` (bfloat16 on the card unless "float32" or
"int8"; the CPU runs float32), with the same refusals of tiling, TTA and
``.onnx`` weights. int8 quantises the backbone's and the encoder's convs
(models/yolo/quant.py ``QConv``); the decoder stays float, and the int8
path computes everything around the quantised convs in f32 (the port's
YOLO int8 path does the same), the AIFI layer between them in f64,
rounded once, so that the card and the CPU quantise alike.
``int8_calibration: N`` calibrates static activation scales from the
first N frames the detector sees, as ``YOLOTorch`` does.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..models import rtdetr
from ..models.yolo import quant
from ..ops.letterbox import resize_stretch_u8
from ..ops.nms import select_topk_batch
from ..utils.device import DeviceLike, device_constant, resolve_device
from .base import Detector
from .types import COCO_NAMES, Detection, DetectionBatch


class RTDETRTorch(Detector):
    nms_free = True      # the engine's dispatch marker
    task = "detect"
    tile_cfg = None      # tiling is YOLO-only (per-anchor merge semantics)
    rect = False         # stretch resize: no letterbox geometry exists
    arch = "rtdetr"

    def __init__(self, cfg: Dict[str, Any], device: DeviceLike = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        self.conf = float(cfg.get("conf_thres", 0.25))
        self.iou = float(cfg.get("iou_thres", 0.7))  # unused: no NMS
        self.max_det = int(cfg.get("max_det", 100))
        self.keep = tuple(sorted(int(x) for x in cfg.get("classes_keep", [])))
        self.imgsz = int(cfg.get("imgsz", 640))
        nq = cfg.get("num_queries")
        if nq is None:
            self.num_queries = min(rtdetr.NQ, max(100, self.max_det))
        else:
            self.num_queries = int(nq)
            if not 1 <= self.num_queries <= rtdetr.NQ:
                raise ValueError(f"detect.num_queries must be in "
                                 f"[1, {rtdetr.NQ}], got {nq}")
            if self.num_queries < self.max_det:
                raise ValueError(
                    f"detect.num_queries ({nq}) < detect.max_det "
                    f"({self.max_det}): top-{self.max_det} selection "
                    f"needs at least that many decoded queries")
        dl = cfg.get("decoder_layers")
        self.decoder_layers = None if dl is None else int(dl)
        if self.decoder_layers is not None \
                and not 1 <= self.decoder_layers <= rtdetr.NDL:
            raise ValueError(f"detect.decoder_layers must be in "
                             f"[1, {rtdetr.NDL}], got {dl}")
        compute = str(cfg.get("compute_dtype", "bfloat16"))
        self.int8 = compute == "int8"
        self.dtype = torch.bfloat16 if compute == "bfloat16" \
            and self.device.type == "cuda" else torch.float32
        if (cfg.get("tiling") or {}).get("enable"):
            raise ValueError("detect.tiling supports the YOLO detect task "
                             "only (rtdetr queries have no defined "
                             "cross-tile merge)")
        if cfg.get("tta"):
            raise ValueError("detect.tta supports the YOLO detect task "
                             "only (rtdetr's set prediction has no "
                             "anchor-level augmented merge)")
        model_ref = cfg.get("model", "rtdetr-l.pt")
        if str(model_ref).endswith(".onnx"):
            raise ValueError("the .onnx interchange is implemented for the "
                             "YOLO families only (models/yolo/onnx_io.py); "
                             "rtdetr loads .pt/.npz checkpoints")
        params, _, self.loaded = rtdetr.load_params_rtdetr(model_ref,
                                                           seed=seed)
        if not self.loaded:
            print(f"[roadvision] weights '{model_ref}' not found — running "
                  f"rtdetr-l with random init (seed {seed})")
        self._calib_left = int(cfg.get("int8_calibration", 0)) \
            if self.int8 else 0
        self.set_params(params)

    def _place(self, model: rtdetr.RTDETR) -> rtdetr.RTDETR:
        """int8 (backbone and encoder convs) or the compute dtype, on the
        device, eval mode; channels-last on the card."""
        if self.int8:
            quant.quantize_model_(model.backbone)
            quant.quantize_model_(model.enc)
            # AIFI between quantised convs: f64, rounded once (models/
            # rtdetr.py::AIFI), so the card quantises lat0 as the CPU does
            model.enc.aifi.double()
        else:
            model.set_compute_dtype(self.dtype)
        model = model.to(self.device).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        return model

    def set_params(self, params) -> None:
        """Swap the weights: a tree in the JAX package's layout
        (``load_params_rtdetr``, ``RTDETRJax.params``); nc and the class
        names follow its ``dec.enc_score`` head."""
        self.params = params
        self.nc = rtdetr.nc_of(params)
        self.model = self._place(rtdetr.model_from_params(params))
        self.names = {i: n for i, n in enumerate(COCO_NAMES)} \
            if self.nc == len(COCO_NAMES) \
            else {i: str(i) for i in range(self.nc)}

    # ------------------------------------------------------------------
    def letterbox(self, frames_u8: torch.Tensor):
        """(imgs, ratio, pad) as the YOLO backend gives them, for a
        stretch resize: ratio 1 and pad 0, so the engine's rescale is the
        multiplication by (w, h) alone."""
        return (resize_stretch_u8(frames_u8, size=self.imgsz), 1.0,
                device_constant([0.0, 0.0], torch.float32, frames_u8.device))

    @torch.inference_mode()
    def forward(self, imgs: torch.Tensor):
        """(B, S, S, 3) float RGB [0, 1] → (boxes normalised xyxy
        (B, nq, 4), scores (B, nq, nc) probabilities)."""
        return self.model(imgs, num_queries=self.num_queries,
                          decoder_layers=self.decoder_layers)

    # ------------------------------------------------------------------
    def calibration_step(self, imgs: torch.Tensor) -> None:
        """``int8_calibration: N``: fold this batch into the running
        abs-max; after N frames bake the static scales."""
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
        # the deployed graph (num_queries, decoder_layers), as the JAX
        # calibration captures it
        self.forward(imgs)

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
        """(B, H, W, 3) uint8 frames on the device → (the model's
        outputs, ratio, pad)."""
        imgs, ratio, pad = lb if lb is not None else self.letterbox(frames_u8)
        self.calibration_step(imgs)
        return self.forward(imgs), ratio, pad

    def postprocess(self, raw, ratio, pad, hw):
        """Score threshold → classes_keep → top-max_det, then × (w, h)
        and the frame clip → (boxes, conf, cls, valid, None)."""
        h, w = hw
        boxes_n, probs = raw
        b, c, k, v = select_topk_batch(
            boxes_n, probs, conf_thres=self.conf, max_det=self.max_det,
            classes_keep=self.keep or None)
        # (w, h, w, h) uploaded once per frame size: a captured step
        # uploads nothing
        lim = device_constant([float(w), float(h), float(w), float(h)],
                              torch.float32, b.device)
        b = b * lim
        return torch.minimum(b.clamp(min=0), lim), c, k, v, None

    @torch.inference_mode()
    def run(self, frames_u8: torch.Tensor, lb=None):
        """Device frames → (boxes, conf, cls, valid, None), source pixels."""
        raw, ratio, pad = self.candidates(frames_u8, lb)
        return self.postprocess(raw, ratio, pad, tuple(frames_u8.shape[1:3]))

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def infer_batch(self, frames_u8: np.ndarray) -> DetectionBatch:
        """(B, H, W, 3) BGR uint8 → DetectionBatch with (B, max_det)
        arrays in source pixels."""
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8)) \
            .to(self.device)
        boxes, conf, cls_id, valid, _ = self.run(frames)
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
