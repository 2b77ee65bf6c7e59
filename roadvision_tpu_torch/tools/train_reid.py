"""Train the learned re-id embedder — the port of ``tools/train_reid.py``.

Synthetic identities, the batch-hard triplet loss and Adam on
``--device`` (the card unless "cpu" is named); the held-out separation
(same-identity minus cross-identity cosine on identities outside the
training pool) before and after; the weights saved in the JAX layout
for ``tracking.reid_weights`` in either package.

Usage:
  python -m roadvision_tpu_torch.tools.train_reid --steps 600 \\
      --out runs/reid.npz
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..track.reid import (identity_separation, init_reid_params,
                          save_reid_params, train_reid)
from ..utils.device import resolve_device
from ..utils.logging import get_logger

log = get_logger("roadvision.train_reid")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--idents", type=int, default=8,
                    help="identities per batch (P)")
    ap.add_argument("--views", type=int, default=4,
                    help="views per identity per batch (K)")
    ap.add_argument("--pool", type=int, default=128,
                    help="training identity pool size")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--margin", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/reid.npz")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # held-out identities: disjoint from the training pool
    held_out = np.arange(args.pool, args.pool + 16)
    sep0 = identity_separation(init_reid_params(args.seed, device), held_out)
    log.info("held-out separation before training: %.3f", sep0)

    t0 = time.perf_counter()
    params, history = train_reid(
        steps=args.steps, idents=args.idents, views=args.views,
        ident_pool=args.pool, lr=args.lr, margin=args.margin,
        seed=args.seed, log_every=max(1, args.steps // 10), log=log.info,
        device=device)
    log.info("trained %d steps in %.1fs (triplet %.4f → %.4f)",
             args.steps, time.perf_counter() - t0, history[0], history[-1])

    sep1 = identity_separation(params, held_out)
    log.info("held-out separation after training:  %.3f (was %.3f)",
             sep1, sep0)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_reid_params(out, params)
    log.info("saved %s — use it via tracking.reid_weights", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
