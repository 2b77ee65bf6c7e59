"""Checkpoint format converter: .pt / .npz / .onnx → .npz / .onnx — the
port of ``tools/export.py``.

Any YOLO checkpoint the port loads (an ultralytics ``.pt`` state dict,
the repo's ``.npz``, an ultralytics ``.onnx`` export) is written again as
the repo's ``.npz`` or as an ONNX weights carrier with ultralytics-style
fused initializer names. RT-DETR checkpoints (by name, or an ``.npz``
sniffed by content) go to ``.npz`` only: no ONNX weight-carrier name
scheme exists for its decoder. Refuses to overwrite its input. Runs on
the host only.

    python -m roadvision_tpu_torch.tools.export --weights yolov8n.pt \
        --format onnx --out w.onnx
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..detect.registry import _is_rtdetr
from ..models.rtdetr import load_params_rtdetr
from ..models.yolo import onnx_io, weights


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", required=True,
                    help="input checkpoint (.pt / .npz / .onnx)")
    ap.add_argument("--format", choices=("onnx", "npz"), default="onnx")
    ap.add_argument("--out", default=None,
                    help="output path (default: input stem + new suffix)")
    args = ap.parse_args(argv)

    if _is_rtdetr(str(args.weights)):
        if args.format == "onnx":
            print("[roadvision] rtdetr supports --format npz only",
                  file=sys.stderr)
            return 2
        params, nc, loaded = load_params_rtdetr(args.weights)
        if not loaded:
            print(f"[roadvision] cannot load weights from {args.weights}",
                  file=sys.stderr)
            return 2
        label, extra = "rtdetr-l", f", nc={nc}"
    else:
        params, arch, size, _ = weights.load_params(args.weights,
                                                    allow_random=False)
        label, extra = f"yolo{arch}{size}", ""
    out = Path(args.out) if args.out else \
        Path(args.weights).with_suffix(f".{args.format}")
    if out.resolve() == Path(args.weights).resolve():
        print(f"[roadvision] refusing to overwrite the input {out} — "
              f"pass --out for an in-place-style rewrite", file=sys.stderr)
        return 2
    if args.format == "npz":
        weights.export_npz(params, out)
    else:
        onnx_io.export_onnx(params, out, arch=arch)
    n = sum(np.asarray(v).size for v in weights.flatten_tree(params).values())
    print(f"[roadvision] exported {label} ({n:,} params{extra}) -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
