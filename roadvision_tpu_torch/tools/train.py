"""Train or fine-tune a detector — the port of ``tools/train.py``.

The same run as the JAX tool: the family from the weights name and the
checkpoint's head (YOLOv8 / YOLO11 / YOLOv5, the ``-seg`` / ``-pose`` /
``-obb`` heads, RT-DETR-L), synthetic road scenes or a YOLO / COCO /
DOTA dataset, warmup then a cosine or constant learning-rate schedule,
EMA weights, ``--eval-every`` mAP on held-out data, ``--save-every`` and
``--resume``, train-time fog, mosaic and flip + HSV augmentation, the
divergence breaker and the final-save guard. The model trains in float32
on ``--device`` (the card unless "cpu" is named). Training state and the
``.weights.npz`` / ``.raw.npz`` exports are written in the JAX package's
layout, so either package resumes or serves them. ``--dp N`` trains N
data-parallel replicas (``parallel/data.py``): N cards, or N replicas on
the CPU with ``--device cpu``; ``--batch`` is the global batch, split
evenly over them, and the losses, gradients and updates are the one-card
step's on that batch. The state is saved from replica 0 and resumed onto
every replica.

Usage:
  python -m roadvision_tpu_torch.cli train --data synthetic --steps 50 \\
      --imgsz 320 --batch 8 --out runs/ft.npz
  python -m roadvision_tpu_torch.cli train --data yolo_dir|coco.json \\
      --weights yolov8n.pt --steps 500 --lr 5e-4 --device cpu
  python -m roadvision_tpu_torch.cli train --dp 4 --batch 64 --imgsz 640
"""
from __future__ import annotations

import argparse
import copy
import math
import time
from pathlib import Path

import numpy as np
import torch

from ..detect import dataset as ds
from ..detect.yolo_torch import _TASK_SUFFIX
from ..models.yolo import weights as yolo_weights
from ..parallel import DataParallelStep, make_mesh
from ..runtime.checkpoint import (load_train_state, opt_state_from_tree,
                                  save_train_state)
from ..utils.logging import get_logger

log = get_logger("roadvision.train")


def lr_scale_at(it: int, steps: int, warmup: int, schedule: str = "cosine",
                lrf: float = 0.01) -> float:
    """Linear warmup to 1, then cosine down to ``lrf`` (held there past
    the horizon) or constant (tools/train.py:291-299)."""
    if it <= warmup:
        return it / warmup
    if schedule == "cosine":
        t = min((it - warmup) / max(steps - warmup, 1), 1.0)
        return lrf + (1.0 - lrf) * 0.5 * (1.0 + math.cos(math.pi * t))
    return 1.0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' or a YOLO-format directory")
    ap.add_argument("--weights", default="yolov8n.pt",
                    help=".pt/.npz to start from (random init if missing)")
    ap.add_argument("--size", default=None, help="model size n/s/m/l/x")
    ap.add_argument("--nc", type=int, default=80)
    ap.add_argument("--imgsz", type=int, default=320)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", choices=["cosine", "constant"],
                    default="cosine")
    ap.add_argument("--warmup", type=int, default=None,
                    help="linear warmup steps (default: steps/10, max 100)")
    ap.add_argument("--lrf", type=float, default=0.01,
                    help="final LR fraction for the cosine schedule")
    ap.add_argument("--ema", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="track EMA weights and export them as the "
                         "deploy weights (raw weights also saved)")
    ap.add_argument("--augment", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="train-time flip + HSV jitter (dataset data)")
    ap.add_argument("--fog", type=float, default=0.0, metavar="P",
                    help="probability per image of the fog synthesizer "
                         "(0 disables)")
    ap.add_argument("--fog-level", default="random",
                    choices=["random", "light", "medium", "heavy"])
    ap.add_argument("--mosaic", type=float, default=1.0,
                    help="probability of a 4-image mosaic per batch "
                         "(dataset data; 0 disables)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="score mAP@0.5 on held-out data every N steps "
                         "(0 = off); EMA weights when enabled")
    ap.add_argument("--eval-size", type=int, default=16)
    ap.add_argument("--out", default="runs/trained.npz")
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint the training state (and the deploy "
                         "weights) to --out every N steps")
    ap.add_argument("--resume", default=None,
                    help="training-state .npz to continue from (either "
                         "package's)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel replicas: cards, or CPU replicas "
                         "with --device cpu (--batch is split over them)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


class Family:
    """What one model family trains with: its model (float32, on the
    device), its step and its optimiser state."""

    def __init__(self, args, device: torch.device):
        name = str(args.weights).lower()
        self.rtdetr = "rtdetr" in name
        if self.rtdetr:
            from ..models import rtdetr
            tree, args.nc, loaded = rtdetr.load_params_rtdetr(
                args.weights, nc=args.nc)
            self.arch, self.size, self.task = "rtdetr", "l", "detect"
            log.info("model rtdetr-l (%s weights, nc=%d)",
                     "pretrained" if loaded else "random", args.nc)
        else:
            arch_hint = "v5" if "yolov5" in name \
                else "11" if "yolo11" in name else "v8"
            task = next((t for t, sfx in _TASK_SUFFIX.items()
                         if sfx in name), "detect")
            tree, self.arch, self.size, loaded = yolo_weights.load_params(
                args.weights, size=args.size or "n", nc=args.nc,
                arch=arch_hint, task=task)
            # the checkpoint's head wins over the name; its width over --nc
            _, found, _, nc = yolo_weights.describe(tree)
            self.task = found if self.arch != "v5" else "detect"
            args.nc = nc
            log.info("model yolo%s%s%s (%s weights, nc=%d)", self.arch,
                     self.size, _TASK_SUFFIX.get(self.task, ""),
                     "pretrained" if loaded else "random", args.nc)
        self.model = yolo_weights.model_from_params(tree) \
            .set_compute_dtype(torch.float32).to(device).train()
        self.step, self.opt = self._step(args.lr)

    def _step(self, lr: float):
        from ..models.yolo import train
        if self.rtdetr:
            from ..models.rtdetr_train import (init_opt_rtdetr,
                                               make_train_step_rtdetr)
            return make_train_step_rtdetr(lr=lr), init_opt_rtdetr(self.model)
        if self.arch == "v5":
            from ..models.yolo.train_v5 import detection_loss_v5 as loss
        elif self.task == "segment":
            from ..models.yolo.train_seg import segmentation_loss as loss
        elif self.task == "pose":
            from ..models.yolo.train_pose import pose_loss as loss
        elif self.task == "obb":
            from ..models.yolo.train_obb import obb_loss as loss
        else:
            loss = train.detection_loss
        return train.make_train_step(loss, lr), \
            train.init_momentum(self.model)

    def eval_detector(self, imgsz: int, device: torch.device):
        """A detector of the same family for ``--eval-every``; its weights
        are set from the live tree before each evaluation."""
        cfg = {"imgsz": imgsz, "conf_thres": 0.25, "max_det": 50,
               "classes_keep": [], "rect": False}
        if self.rtdetr:
            from ..detect.rtdetr_torch import RTDETRTorch
            return RTDETRTorch(dict(cfg, model="rtdetr-l.eval"), device)
        from ..detect.yolo_torch import YOLOTorch
        return YOLOTorch(dict(cfg, model=f"yolo{self.arch}{self.size}"
                              f"{_TASK_SUFFIX.get(self.task, '')}.eval"),
                         device)


def _batches(args, fam: Family, ap):
    """(next_batch, eval_set): host numpy batches (images u8 RGB, gts…)."""
    task = fam.task
    if args.data == "synthetic":
        gen = {"segment": ds.synthetic_seg_batches,
               "pose": ds.synthetic_pose_batches,
               "obb": ds.synthetic_obb_batches}.get(task, ds.synthetic_batches)
        batches = gen(args.batch, imgsz=args.imgsz)
        eval_set = None
        if args.eval_every:
            held = {"pose": ds.synthetic_pose_batches,
                    "obb": ds.synthetic_obb_batches}.get(
                        task, ds.synthetic_batches)
            eval_set = next(held(args.eval_size, imgsz=args.imgsz, seed=999))
        return (lambda: next(batches)), eval_set

    if task in ("segment", "pose"):
        if not str(args.data).endswith(".json"):
            ap.error(f"{task} training takes a COCO annotation JSON "
                     f"(--data annotations.json)")
        load = ds.load_coco_seg_json if task == "segment" \
            else ds.load_coco_kpts_json
        data = load(args.data, imgsz=args.imgsz)
    elif task == "obb":
        data = ds.load_yolo_obb_dir(args.data, imgsz=args.imgsz)
    else:
        data = ds.load_dataset(args.data, imgsz=args.imgsz)
    imgs, *gt_arrays = data
    eval_set = None
    if args.eval_every and imgs.shape[0] > 2:
        k = min(args.eval_size, imgs.shape[0] // 3)
        keep = gt_arrays[:3] if task == "segment" else gt_arrays
        eval_set = (imgs[-k:],) + tuple(g[-k:] for g in keep)
        imgs = imgs[:-k]
        gt_arrays = [g[:-k] for g in gt_arrays]
        log.info("held out %d images for eval", k)
    n = imgs.shape[0]
    plain = task == "detect"
    log.info("dataset: %d images%s%s", n,
             " (flip+HSV augment)" if args.augment and plain else "",
             f" (mosaic p={args.mosaic})"
             if args.mosaic > 0 and plain else "")
    rng = np.random.RandomState(0)

    def next_batch():
        idx = rng.randint(0, n, args.batch)
        bi = imgs[idx]
        gts = [g[idx] for g in gt_arrays]
        if plain:
            bb, bc, bm = gts
            if args.mosaic > 0 and rng.rand() < args.mosaic:
                bi, bb, bc, bm = ds.mosaic_batch(bi, bb, bc, bm, rng)
            if args.augment:
                bi, bb = ds.augment_batch(bi, bb, bm, rng)
            return bi, bb, bc, bm
        return (bi, *gts)

    return next_batch, eval_set


def _evaluate(fam: Family, det, weights: torch.nn.Module, eval_set) -> dict:
    from ..detect import eval as ev
    det.set_params(yolo_weights.tree_from_model(weights))
    if fam.task == "pose":
        imgs, boxes, _cls, mask, kpts = eval_set
        return ev.evaluate_pose(det, imgs, boxes, kpts, mask)
    if fam.task == "obb":
        return ev.evaluate_obb(det, *eval_set)
    return ev.evaluate_detector(det, *eval_set)


def _export(model: torch.nn.Module, path: Path) -> None:
    yolo_weights.export_npz(yolo_weights.tree_from_model(model), path)


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.batch % args.dp:
        raise ValueError(f"--batch {args.batch} does not split evenly over "
                         f"--dp {args.dp}")
    mesh = make_mesh(args.dp, device=args.device)
    device = mesh.grid[0][0]
    fam = Family(args, device)
    model = fam.model

    start_step = 0
    if args.resume:
        params, opt_tree, start_step = load_train_state(args.resume)
        model.load_state_dict({k: v.to(device) for k, v in
                               yolo_weights.params_from_jax(params).items()})
        if fam.rtdetr and not (isinstance(opt_tree, dict)
                               and set(opt_tree) == {"m", "v", "t"}):
            # an old RT-DETR checkpoint with SGD momentum: keep params and
            # step, start the AdamW moments afresh
            log.warning("resume checkpoint %s carries the old SGD momentum "
                        "tree; re-initializing AdamW moments (params and "
                        "step count are kept)", args.resume)
        else:
            fam.opt = opt_state_from_tree(opt_tree, device)
        log.info("resumed from %s at step %d", args.resume, start_step)
    # replica 0 is ``model``: the EMA, the evaluation and the saves read it
    step = DataParallelStep(fam.step, model, mesh, state=fam.opt)
    opt = step.state
    if args.dp > 1:
        log.info("data parallel over %d replicas: %s", args.dp,
                 [str(row[0]) for row in mesh.grid])

    next_batch, eval_set = _batches(args, fam, ap)
    warmup = args.warmup if args.warmup is not None \
        else min(100, max(1, args.steps // 10))

    from ..models.yolo.train import make_ema_update
    # a real copy: the step updates the live parameters in place
    ema = copy.deepcopy(model) if args.ema else None
    ema_update = make_ema_update() if args.ema else None
    eval_det = None

    fog_rng = np.random.RandomState(77)
    if args.fog > 0:
        log.info("fog augmentation: p=%.2f level=%s", args.fog,
                 args.fog_level)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    nan_logs = 0
    loss = torch.tensor(float("nan"))
    for it in range(1, args.steps + 1):
        images, *gts = next_batch()
        if args.fog > 0:
            images = ds.fog_augment_batch(np.asarray(images), fog_rng,
                                          p=args.fog, level=args.fog_level,
                                          device=device)
        x = torch.from_numpy(np.asarray(images)).to(device).float() / 255.0
        loss, aux = step(
            x, *(torch.from_numpy(np.asarray(g)).to(device) for g in gts),
            lr_scale=lr_scale_at(start_step + it, args.steps, warmup,
                                 args.schedule, args.lrf))
        if ema is not None:
            ema_update(ema, model, start_step + it)
        if args.eval_every and eval_set is not None \
                and (it % args.eval_every == 0 or it == args.steps):
            if eval_det is None:
                eval_det = fam.eval_detector(args.imgsz, device)
            score = _evaluate(fam, eval_det, ema if ema is not None
                              else model, eval_set)
            log.info("eval @%d: %s", start_step + it,
                     " ".join(f"{k}={v:.3f}" for k, v in score.items()))
        if it % args.log_every == 0 or it == args.steps:
            parts = " ".join(
                f"{k}={float(v):.3f}" for k, v in sorted(aux.items())
                if k not in ("num_fg", "grad_norm", "ok"))
            log.info("step %d/%d loss=%.4f %s fg=%d (%.1fs)",
                     it, args.steps, float(loss), parts,
                     int(aux["num_fg"]), time.time() - t0)
            # divergence breaker: two log points in a row with a
            # non-finite loss mean the parameters have overflowed
            if np.isfinite(float(loss)):
                nan_logs = 0
            else:
                nan_logs += 1
                if nan_logs >= 2:
                    log.error(
                        "loss non-finite at %d consecutive log points — "
                        "params have diverged (overflowed to inf/NaN); "
                        "aborting without checkpointing. Lower --lr "
                        "and/or raise --warmup and restart%s.", nan_logs,
                        " (resume from the last finite checkpoint)"
                        if args.save_every else "")
                    return 1
        if args.save_every and it % args.save_every == 0 \
                and it != args.steps and nan_logs == 0 \
                and np.isfinite(float(loss)):
            save_train_state(out, model, opt, start_step + it)
            _export(ema if ema is not None else model,
                    out.with_suffix(".weights.npz"))
            log.info("checkpointed step %d to %s", start_step + it, out)

    if args.steps > 0 and not np.isfinite(float(loss)):
        # never overwrite a good --save-every checkpoint with diverged
        # parameters
        log.error("final loss is non-finite — params diverged; NOT "
                  "overwriting %s (resume from the last finite "
                  "checkpoint with a lower --lr)", out)
        return 1
    path = save_train_state(out, model, opt, start_step + args.steps)
    _export(ema if ema is not None else model,
            out.with_suffix(".weights.npz"))
    if ema is not None:
        _export(model, out.with_suffix(".raw.npz"))
    log.info("saved training state to %s and %sweights to %s", path,
             "EMA " if ema is not None else "",
             out.with_suffix(".weights.npz"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
