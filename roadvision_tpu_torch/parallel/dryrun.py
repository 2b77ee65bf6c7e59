"""The multi-card dry run — the counterpart of
``__graft_entry__.py::dryrun_multichip``: the same checks in the same
order, one step each on tiny shapes, printing the same ``[dryrun]``
lines:

  1. the dp × tp YOLOv8n train step (mesh ``{data: n/2, model: 2}`` when
     n ≥ 4 and even, else ``{data: n, model: 1}``);
  2. the config-driven camera fleet (``tpu.mesh`` over the devices) and
     its temporal gate;
  3. the 4-stage (or n-stage) YOLOv8 and RT-DETR pipelines against the
     plain forward;
  4. the dp × tp RT-DETR AdamW step;
  5. the row-sharded forward against the plain one.

The devices may repeat (``["cpu"] * 8``, ``[cuda:0] * 8``). A failed
check raises.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"[dryrun] {msg}")


def _max_err(got, want) -> float:
    return max(float((a.float().cpu() - b.float().cpu()).abs().max())
               for a, b in zip(got, want))


def _gts(rng, bs: int, nc: int):
    xy = rng.uniform(5, 40, (bs, 3, 2)).astype(np.float32)
    wh = rng.uniform(8, 20, (bs, 3, 2)).astype(np.float32)
    return (torch.from_numpy(np.concatenate([xy, xy + wh], -1)),
            torch.from_numpy(rng.randint(0, nc, (bs, 3)).astype(np.int32)),
            torch.ones((bs, 3), dtype=torch.bool))


def dryrun_multicard(devices: Sequence[DeviceLike]) -> None:
    """Run the checks over ``devices``; raise on the first that fails."""
    from ..config import DEFAULTS, merge
    from ..models import rtdetr
    from ..models.rtdetr_train import make_train_step_rtdetr
    from ..models.yolo import train as T
    from ..models.yolo import weights as W
    from ..runtime import MultiStreamEngine
    from .data import DataParallelStep
    from .pipeline import PipelinedRTDETR, PipelinedYOLO, v8_detect_model
    from .sharding import make_mesh
    from .spatial import make_spatial_forward, spatial_sharding

    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    f32 = torch.float32
    mp = 2 if (n >= 4 and n % 2 == 0) else 1
    mesh = make_mesh(model_parallel=mp, devices=devices)
    print(f"[dryrun] mesh axes: {mesh.shape}", flush=True)

    dp = mesh.shape["data"]
    bs = max(dp, n)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(bs, 64, 64, 3).astype(np.float32))
    model = W.random_model("v8", "detect", "n", 80, seed=0) \
        .set_compute_dtype(f32).train()
    step = DataParallelStep(T.make_train_step(lr=1e-3), model, mesh)
    loss, aux = step(images, *_gts(rng, bs, 80))
    _check(bool(torch.isfinite(loss)), f"train step loss {float(loss)}")
    print(f"[dryrun] one sharded train step OK: loss={float(loss):.4f} "
          f"num_fg={int(aux['num_fg'])} devices={n} dp={dp} tp={mp}",
          flush=True)

    # the camera fleet through the config path, one group per device
    s, bsz, h, w = n, 2, 64, 64
    cfg = merge(DEFAULTS, {
        "camera": {"width": w, "height": h,
                   "sources": [f"synthetic:{2 + i}" for i in range(s)]},
        "detect": {"enabled": True, "model": "missing.pt", "max_det": 8,
                   "imgsz": 64, "classes_keep": [], "conf_thres": 0.0},
        "tracking": {"enabled": True},
        "tpu": {"batch_size": bsz, "track_slots": 8,
                "mesh": {"enable": True, "axis": "data"}},
    })
    mengine = MultiStreamEngine(cfg, num_streams=s, devices=devices)
    frames = rng.randint(0, 256, (s, bsz, h, w, 3)).astype(np.uint8)
    ts = np.arange(s * bsz, dtype=np.float32).reshape(s, bsz) / 30.0
    results = mengine.process_batch(frames, ts)
    n_out = sum(len(r.detections) for stream in results for r in stream)
    spanned = sum(g.states is not None for g in mengine.groups)
    _check(spanned == n, f"stream states span {spanned}/{n} devices")
    print(f"[dryrun] config-driven {s}-stream sharded inference OK: "
          f"detections={n_out} mesh={{'data': {len(mengine.devices)}}} "
          f"devices_spanned={spanned}", flush=True)

    gcfg = merge(cfg, {"detect": {"temporal_gate": {
        "enable": True, "thresh": 1.5, "max_skip_batches": 3}}})
    geng = MultiStreamEngine(gcfg, num_streams=s, devices=devices)
    static = np.broadcast_to(frames[0, 0][None, None],
                             (s, bsz, h, w, 3)).copy()
    geng.process_batch(static, ts)
    geng.process_batch(static, ts + bsz / 30.0)
    _check(geng.gate_frames_coasted == s * bsz,
           f"static fleet did not coast ({geng.gate_frames_coasted})")
    moved = static.copy()
    moved[0, -1] = frames[0, 1]  # one stream moves
    geng.process_batch(moved, ts + 2 * bsz / 30.0)
    _check(geng.gate_frames_coasted == s * bsz,
           "a moving stream must wake the whole fleet")
    print(f"[dryrun] fleet temporal gate OK: static fleet coasted "
          f"{geng.gate_frames_coasted} frames; one moving stream forced "
          f"a full pass", flush=True)

    pp = min(4, n)
    pparams = W.tree_from_model(W.random_model("v8", "detect", "n", 80,
                                               seed=1))
    x = torch.from_numpy(rng.rand(4, 64, 64, 3).astype(np.float32))
    pipe = PipelinedYOLO(pparams, "n", 80, n_stages=pp, devices=devices)
    plain = v8_detect_model(pparams, "n", 80, f32).to(devices[0])
    with torch.inference_mode():
        err = _max_err(pipe(x), plain(x.to(devices[0])))
    _check(err < 1e-3, f"pipeline-parallel forward diverges: max|Δ|={err}")
    print(f"[dryrun] {pp}-stage pipeline-parallel inference OK: "
          f"max|Δ|={err:.2e} groups={[list(g) for g in pipe.groups]}",
          flush=True)

    rt_model = rtdetr.random_model(7, seed=2)
    rt_params = rtdetr.tree_from_model(rt_model)
    xr = torch.from_numpy(rng.rand(2, 64, 64, 3).astype(np.float32))
    rt_pipe = PipelinedRTDETR(rt_params, nc=7, n_stages=min(4, n),
                              devices=devices)
    with torch.inference_mode():
        rerr = _max_err(rt_pipe(xr), rt_model.to(devices[0]).eval()(
            xr.to(devices[0]), num_queries=rtdetr.NQ))
    _check(rerr < 1e-3, f"rtdetr pipeline forward diverges: max|Δ|={rerr}")
    print(f"[dryrun] {rt_pipe.n_stages}-stage rtdetr pipeline OK: "
          f"max|Δ|={rerr:.2e}", flush=True)

    xt = torch.from_numpy(rng.rand(bs, 64, 64, 3).astype(np.float32))
    rt_step = DataParallelStep(make_train_step_rtdetr(lr=1e-4),
                               rt_model.train(), mesh)
    rt_loss, rt_aux = rt_step(xt, *_gts(rng, bs, 7))
    _check(bool(torch.isfinite(rt_loss)), f"rtdetr loss {float(rt_loss)}")
    print(f"[dryrun] one sharded rtdetr train step OK: "
          f"loss={float(rt_loss):.4f} num_fg={int(rt_aux['num_fg'])}",
          flush=True)

    sp_mesh = make_mesh(model_parallel=1, devices=devices)
    xs = torch.from_numpy(rng.rand(1, 32 * n, 96, 3).astype(np.float32))
    run_sp = make_spatial_forward("n", 80, sp_mesh)
    with torch.inference_mode():
        serr = _max_err(run_sp(pparams, xs), plain(xs.to(devices[0])))
    _check(serr < 1e-3, f"spatially-sharded forward diverges: max|Δ|={serr}")
    n_span = len(spatial_sharding(sp_mesh, xs).parts)
    _check(n_span == n, f"the frame spans {n_span}/{n} devices")
    print(f"[dryrun] row-sharded (sp) inference OK: max|Δ|={serr:.2e} "
          f"bands={n}×32 rows", flush=True)
