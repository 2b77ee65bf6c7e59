"""Checkpoint format converter: .pt / .npz / .onnx → .npz / .onnx — the
port of ``tools/export.py``.

Any YOLO checkpoint the port loads (an ultralytics ``.pt`` state dict,
the repo's ``.npz``, an ultralytics ``.onnx`` export) is written again as
the repo's ``.npz`` or as an ONNX weights carrier with ultralytics-style
fused initializer names. Refuses to overwrite its input; RT-DETR is
refused (ROADMAP queue A item 6). Runs on the host only.

    python -m roadvision_tpu_torch.tools.export --weights yolov8n.pt \
        --format onnx --out w.onnx
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..detect.registry import _is_rtdetr
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
        print("[roadvision] RT-DETR is not ported to roadvision_tpu_torch "
              "yet (ROADMAP queue A item 6)", file=sys.stderr)
        return 2
    params, arch, size, _ = weights.load_params(args.weights,
                                                allow_random=False)
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
    print(f"[roadvision] exported yolo{arch}{size} ({n:,} params) -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
