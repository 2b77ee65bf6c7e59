"""Warm a deployment's shapes before its first real frame — the port of
``tools/warmup.py``.

    python -m roadvision_tpu_torch.tools.warmup [--config C.yaml]
        [--res 1080[,720,...]] [--batch N] [--device cuda|cpu]

Under XLA every (batch, H, W) shape of the fused step compiles on first
dispatch, and the JAX tool fills the persistent compilation cache. The
port's first frames pay for other things: the hand-written kernels'
``nvcc`` build (cached on disk by ``kernels/_build.py``, see
``utils/cache.py``) and cuDNN's per-shape algorithm choice (made in the
process, on the first batch of each shape). This tool builds every
kernel, then drives one synthetic batch through each shape the
deployment will see, with the processed frames returned (``want_proc``
True, as the preview streams) and not (False, as the bench and headless
paths run), and, where the temporal gate is configured, a second batch
of the same static frames, which coasts, so that the coast step is warm
too.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..config import load_config
from ..runtime import PipelineEngine
from ..utils import get_logger, res_width

log = get_logger("roadvision.warmup")


def warm_shape(engine: PipelineEngine, height: int, width: int,
               batch: int) -> None:
    frames = np.zeros((batch, height, width, 3), np.uint8)
    ts = np.arange(batch, dtype=np.float64) / 30.0
    for want_proc in (True, False):
        t0 = time.perf_counter()
        engine.reset()
        engine.process_batch(frames, ts, want_proc=want_proc)
        if engine._gate_cfg is not None and batch >= 2:
            # zero frames score as static: the second batch coasts
            engine.process_batch(frames, ts + batch / 30.0,
                                 want_proc=want_proc)
            if engine.gate_frames_coasted <= 0:
                raise RuntimeError("warmup: the gate's second static "
                                   "batch did not coast")
        log.info("warmed (%d, %d, %d) want_proc=%s in %.1fs",
                 batch, height, width, want_proc,
                 time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None,
                    help="YAML config (same file the deployment runs)")
    ap.add_argument("--res", default=None,
                    help="comma-separated heights to warm (e.g. 1080,720); "
                         "default: the configured camera resolution")
    ap.add_argument("--batch", type=int, default=None,
                    help="override tpu.batch_size")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    if args.batch:
        cfg.setdefault("tpu", {})["batch_size"] = int(args.batch)
    engine = PipelineEngine(cfg, device=args.device)
    if engine.device.type == "cuda":
        from .. import kernels
        t0 = time.perf_counter()
        paths = kernels.build_all()
        log.info("kernels built in %.1fs under %s",
                 time.perf_counter() - t0,
                 next(iter(paths.values())).parent)

    if args.res:
        shapes = []
        for tok in str(args.res).split(","):
            h = int(tok)
            shapes.append((h, res_width(h)))
    else:
        cam = cfg.get("camera", {}) or {}
        h = int(cam.get("height", 480))
        shapes = [(h, int(cam.get("width", res_width(h))))]

    t0 = time.perf_counter()
    for h, w in shapes:
        warm_shape(engine, h, w, engine.batch_size)
    log.info("warmup complete: %d shape(s) in %.1fs",
             len(shapes), time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
