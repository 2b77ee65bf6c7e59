"""Pipeline parallelism: stage-per-device microbatched YOLOv8 and RT-DETR
inference — the counterpart of ``roadvision_tpu/parallel/pipeline.py``.

The v8 graph is cut at its FPN boundaries into the JAX package's four
fine stages (the same layer keys, the skip tensors p3 / p4 / h4 / p5 in
the carry); RT-DETR at its subsystems (HGNetv2's two halves, the hybrid
encoder, the deformable decoder). The fine stages are grouped into
``n_stages`` contiguous coarse stages balanced by parameter count, each
coarse stage's modules on its own device.

The GPipe schedule is the host's order of enqueueing, as JAX's async
dispatch is: microbatch m's stage s, then its copy to the next device,
then microbatch m+1's stage s on the device just freed. No stage reads a
value back to the host and the copies between devices are asynchronous,
so stage s of microbatch m+1 may run while stage s+1 of m does, once a
stage's device work outlasts the host's enqueueing of the next (at the
sizes `chip_smoke.py` measures it does not: PERF.md's multi-card
findings). Over one device repeated, the stages run one after another.
"""
from __future__ import annotations

from itertools import combinations
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..models import rtdetr
from ..models.yolo import weights as yolo_weights
from ..models.yolo.yolov8 import YOLOv8, _up2, decode
from ..utils.device import DeviceLike, resolve_device, visible_devices

# Parameter keys of each fine stage (ultralytics layer indices), as JAX's
STAGE_KEYS: Sequence[Sequence[str]] = (
    ("0", "1", "2", "3", "4"),          # stem → P3 backbone
    ("5", "6"),                          # P4 backbone
    ("7", "8", "9", "12"),               # P5 backbone + SPPF + top-down h4
    ("15", "16", "18", "19", "21", "22"),  # PAN bottom-up + detect head
)


def _fine0(L, c, nc, dtype):
    y = L["1"](L["0"](c["x"].permute(0, 3, 1, 2).to(dtype)))
    y = L["2"](y)
    return {"p3": L["4"](L["3"](y))}


def _fine1(L, c, nc, dtype):
    return {"p3": c["p3"], "p4": L["6"](L["5"](c["p3"]))}


def _fine2(L, c, nc, dtype):
    p5 = L["9"](L["8"](L["7"](c["p4"])))
    h4 = L["12"](torch.cat([_up2(p5), c["p4"]], dim=1))
    return {"p3": c["p3"], "h4": h4, "p5": p5}


def _fine3(L, c, nc, dtype):
    out3 = L["15"](torch.cat([_up2(c["h4"]), c["p3"]], dim=1))
    out4 = L["18"](torch.cat([L["16"](out3), c["h4"]], dim=1))
    out5 = L["21"](torch.cat([L["19"](out4), c["p5"]], dim=1))
    boxes, scores = decode(L["22"]([out3, out4, out5]), nc)
    return {"boxes": boxes, "scores": scores}


_FINE_FNS = (_fine0, _fine1, _fine2, _fine3)


def _leaf_count(tree) -> int:
    return sum(int(np.prod(np.shape(v)))
               for v in yolo_weights.flatten_tree(tree).values())


def _balanced_groups(weights: Sequence[int], n_groups: int) -> List[range]:
    """Contiguous partition of fine stages minimizing the max group weight
    (brute force over cut points — there are at most C(3, n-1) options)."""
    n = len(weights)
    best, best_cost = None, None
    for cuts in combinations(range(1, n), n_groups - 1):
        bounds = [0, *cuts, n]
        groups = [range(bounds[i], bounds[i + 1]) for i in range(n_groups)]
        cost = max(sum(weights[j] for j in g) for g in groups)
        if best_cost is None or cost < best_cost:
            best, best_cost = groups, cost
    return best


def v8_detect_model(params: Dict[str, Any], size: str, nc: int,
                    dtype: torch.dtype) -> YOLOv8:
    """The YOLOv8 detect graph of a JAX-layout v8 tree (a task head's
    extra branches left out), in eval mode with ``dtype`` weights."""
    missing = [k for g in STAGE_KEYS for k in g if k not in params]
    if missing or yolo_weights.describe(params)[0] != "v8":
        raise ValueError(f"param tree missing layers {missing} "
                         "(the v8 detect graph only)")
    model = YOLOv8(size, nc)
    keys = model.state_dict().keys()
    model.load_state_dict({
        k: v for k, v in yolo_weights.params_from_jax(
            {k: params[k] for g in STAGE_KEYS for k in g}).items()
        if k in keys})
    return model.set_compute_dtype(dtype).eval()


class _Pipelined:
    """What both pipelines share: the device check, the balanced groups,
    the microbatch pick and the schedule. A subclass gives its fine
    stages' functions, their modules and their parameter counts."""

    fine_fns: Sequence[Callable] = ()

    def _setup(self, fine_modules: Sequence[nn.Module],
               weights: Sequence[int], n_stages: int,
               devices: Optional[Sequence[DeviceLike]],
               microbatch: Optional[int], dtype: torch.dtype) -> None:
        devices = visible_devices() if devices is None \
            else [resolve_device(d) for d in devices]
        if len(devices) < n_stages:
            raise ValueError(
                f"pipeline needs {n_stages} devices, have {len(devices)}")
        self.n_stages = n_stages
        self.microbatch = microbatch
        self.dtype = dtype
        self.devices = devices[:n_stages]
        self.groups = _balanced_groups(weights, n_stages)
        self.stage_modules: List[nn.ModuleDict] = [
            nn.ModuleDict({str(j): fine_modules[j] for j in grp}).to(dev)
            for grp, dev in zip(self.groups, self.devices)]

    def _pick_microbatch(self, batch: int) -> int:
        if self.microbatch is not None:
            if batch % self.microbatch != 0:
                raise ValueError(
                    f"batch {batch} not divisible by microbatch "
                    f"{self.microbatch} (uneven tail would recompile)")
            return self.microbatch
        target = 2 * self.n_stages  # GPipe fill ratio
        for mb in range(max(1, batch // target), 0, -1):
            if batch % mb == 0:
                return mb
        return 1

    @torch.inference_mode()
    def __call__(self, x) -> tuple:
        x = torch.as_tensor(x)
        mb = self._pick_microbatch(x.shape[0])
        outs = []
        for s in range(0, x.shape[0], mb):
            carry: Dict[str, Any] = {
                "x": x[s:s + mb].to(self.devices[0], non_blocking=True)}
            for i, (grp, mods) in enumerate(zip(self.groups,
                                                self.stage_modules)):
                if i:
                    carry = {k: v.to(self.devices[i], non_blocking=True)
                             for k, v in carry.items()}
                for j in grp:
                    carry = self.fine_fns[j](mods[str(j)], carry, self.nc,
                                             self.dtype)
            outs.append(carry)
        return (torch.cat([o["boxes"] for o in outs]),
                torch.cat([o["scores"] for o in outs]))


class PipelinedYOLO(_Pipelined):
    """YOLOv8 forward split over ``n_stages`` devices (2 ≤ n ≤ 4), cut
    from the JAX-layout tree ``params``: (B, H, W, 3) float in [0, 1] →
    (boxes (B, N, 4), scores (B, N, nc)) on the last stage's device, the
    same as the single-device forward. ``devices`` defaults to every
    visible card; repeats are allowed. ``microbatch`` defaults to the
    largest divisor of the batch that gives at least 2·n_stages
    microbatches."""

    fine_fns = _FINE_FNS

    def __init__(self, params: Dict[str, Any], size: str = "n", nc: int = 80,
                 n_stages: int = 2,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 microbatch: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        if not 2 <= n_stages <= len(STAGE_KEYS):
            raise ValueError(
                f"n_stages={n_stages} unsupported (2..{len(STAGE_KEYS)})")
        self.nc = nc
        model = v8_detect_model(params, size, nc, dtype)
        fine = [nn.ModuleDict({k: model.layers[k] for k in g})
                for g in STAGE_KEYS]
        weights = [_leaf_count({k: params[k] for k in g})
                   for g in STAGE_KEYS]
        self._setup(fine, weights, n_stages, devices, microbatch, dtype)


def _rt_fine0(P, c, nc, dtype):
    y = P["stem"](c["x"].permute(0, 3, 1, 2).to(dtype))
    for blk in P["s0"]:
        y = blk(y)
    y = P["d0"](y)
    for blk in P["s1"]:
        y = blk(y)
    return {"c3": y}


def _rt_fine1(P, c, nc, dtype):
    y = P["d1"](c["c3"])
    for blk in P["s2"]:
        y = blk(y)
    c4 = y
    y = P["d2"](c4)
    for blk in P["s3"]:
        y = blk(y)
    return {"c3": c["c3"], "c4": c4, "c5": y}


def _rt_fine2(P, c, nc, dtype):
    f3, f4, f5 = P["enc"](c["c3"], c["c4"], c["c5"])
    return {"f3": f3, "f4": f4, "f5": f5}


def _rt_fine3(P, c, nc, dtype):
    boxes, logits = P["dec"]([c["f3"], c["f4"], c["f5"]])
    return {"boxes": rtdetr.box_xyxy(boxes), "scores": torch.sigmoid(logits)}


_RT_FINE_FNS = (_rt_fine0, _rt_fine1, _rt_fine2, _rt_fine3)


def _rt_stage_params(params) -> List[Dict[str, Any]]:
    bk = params["backbone"]
    return [
        {"stem": bk["stem"], "s0": bk["stages"][0], "s1": bk["stages"][1],
         "d0": bk["down"][0]},
        {"s2": bk["stages"][2], "s3": bk["stages"][3],
         "d1": bk["down"][1], "d2": bk["down"][2]},
        params["enc"],
        params["dec"],
    ]


class PipelinedRTDETR(_Pipelined):
    """RT-DETR forward split over ``n_stages`` devices (2 ≤ n ≤ 4), cut
    from the JAX-layout tree ``params``: (B, H, W, 3) float in [0, 1] →
    (boxes xyxy normalised (B, 300, 4), scores (B, 300, nc)), the same
    as the single-device forward with its 300 queries. Devices and
    microbatches as :class:`PipelinedYOLO`'s."""

    fine_fns = _RT_FINE_FNS

    def __init__(self, params: Dict[str, Any], nc: int = 80,
                 n_stages: int = 2,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 microbatch: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        if not 2 <= n_stages <= len(_RT_FINE_FNS):
            raise ValueError(
                f"n_stages={n_stages} unsupported (2..{len(_RT_FINE_FNS)})")
        for key in ("backbone", "enc", "dec"):
            if key not in params:
                raise ValueError(f"param tree missing '{key}' "
                                 "(PipelinedRTDETR wants the rtdetr pytree)")
        if rtdetr.nc_of(params) != nc:
            raise ValueError(f"nc={nc}, the tree's score heads have "
                             f"{rtdetr.nc_of(params)} classes")
        self.nc = nc
        model = rtdetr.model_from_params(params).set_compute_dtype(dtype)
        model.eval()
        bk = model.backbone
        fine = [nn.ModuleDict({"stem": bk.stem, "s0": bk.stages[0],
                               "s1": bk.stages[1], "d0": bk.down[0]}),
                nn.ModuleDict({"s2": bk.stages[2], "s3": bk.stages[3],
                               "d1": bk.down[1], "d2": bk.down[2]}),
                nn.ModuleDict({"enc": model.enc}),
                nn.ModuleDict({"dec": model.dec})]
        weights = [_leaf_count(fp) for fp in _rt_stage_params(params)]
        self._setup(fine, weights, n_stages, devices, microbatch, dtype)
