"""Per-stage RT-DETR profiler — the port of ``tools/profile_rtdetr.py``.

    python -m roadvision_tpu_torch.tools.profile_rtdetr [--res 720]
        [--batch 8] [--imgsz 640] [--dtype bfloat16|float32|int8]
        [--inner 8] [--iters 2] [--weights W] [--out P.json]
        [--device cuda|cpu]

Splits RT-DETR-L's forward (a seeded random init unless ``--weights``
names a checkpoint) into the stretch resize, the HGNetv2 backbone, the
hybrid encoder, the deformable decoder and one decoder layer's
multi-scale deformable attention, plus the whole forward, each in ms a
frame with its FLOPs (``torch.utils.flop_counter.FlopCounterMode``:
matrix products and convolutions) and the rate achieved, and a roofline
line per stage against the card's dense rate for the compute dtype and
its 3.35 TB/s (NVIDIA H100 SXM figures, with the card's name and power
limit beside them).

The decoder is split the way a launch-bound stage needs: its kernel
launches a forward (``torch.profiler``, CUDA activity; on the CPU the
operators dispatched), the bytes its deformable sampling gathers (the
value rows each corner reads, counted from the shapes), what those bytes
take at 3.35 TB/s, and the decoder's time with the gathers in both
formulations of ``RVT_RTDETR_PAIRED_GATHERS`` (12 gathers a layer, or 3).
The decoder decodes the detector's ``num_queries`` (its default,
max(100, max_det)), as the engine does; the JAX tool profiled 300.

Timing: CUDA events around ``--inner`` chained calls after a warm-up of
``--inner`` calls, ``--iters`` times, median (the host clock on the CPU,
where the numbers are no device figure).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..detect.rtdetr_torch import RTDETRTorch
from ..models import rtdetr
from ..ops.letterbox import resize_stretch_u8
from ..utils.device import resolve_device
from ..utils.profiler import time_ms
from ..utils.resolutions import res_width
from .bench import card_line

HBM_BYTES_PER_S = 3.35e12
# dense rates of an H100 SXM at its 700 W limit (NVIDIA's data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}


def flops_of(fn: Callable) -> float:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())


def launches_of(fn: Callable, device: torch.device) -> Dict[str, int]:
    """CUDA kernels a call launches (on a card) and the operators it
    dispatches, from one profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    events = prof.key_averages()
    kernels = sum(e.count for e in events
                  if e.device_type == DeviceType.CUDA)
    ops = sum(e.count for e in events
              if e.device_type == DeviceType.CPU and e.key.startswith("aten::"))
    return {"kernel_launches": kernels if device.type == "cuda" else None,
            "aten_ops": ops}


def gather_bytes(batch: int, nq: int, layers: int, bf16_vals: bool) -> dict:
    """What the deformable sampling of one decoder forward gathers: every
    layer, level, corner, query, head and point reads one row of dh
    values and its int64 row index."""
    rows = layers * rtdetr.NL * 4 * batch * nq * rtdetr.NH * rtdetr.NDP
    dh = rtdetr.HD // rtdetr.NH
    values = rows * dh * (2 if bf16_vals else 4)
    index = rows * 8
    return {"rows": rows, "value_bytes": values, "index_bytes": index,
            "ms_at_hbm": (values + index) / HBM_BYTES_PER_S * 1e3}


def run(args) -> dict:
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, w, b = args.res, res_width(args.res), args.batch
    det = RTDETRTorch({"model": args.weights, "imgsz": args.imgsz,
                       "compute_dtype": args.dtype, "max_det": 100,
                       "conf_thres": 0.25, "classes_keep": []},
                      device=device)
    m = det.model
    nq = det.num_queries
    layers = det.decoder_layers or rtdetr.NDL
    card = card_line() if device.type == "cuda" \
        else "cpu (host clock: no device figure)"
    rng = np.random.RandomState(0)          # the JAX tool's inputs
    frames = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3),
                                          dtype=np.uint8)).to(device)
    print(f"[rtdetr] device={device} res={h}p batch={b} imgsz={args.imgsz} "
          f"dtype={args.dtype} queries={nq} (weights "
          f"{'loaded' if det.loaded else 'RANDOM'}; {card})", flush=True)

    with torch.inference_mode():
        imgs = resize_stretch_u8(frames, size=args.imgsz)
        x = imgs.permute(0, 3, 1, 2).to(m.compute_dtype)
        taps = m.backbone(x)
        feats = m.enc(*taps)
        sizes = [args.imgsz // s for s in (8, 16, 32)]
        shapes = [(s, s) for s in sizes]
        dh = rtdetr.HD // rtdetr.NH
        vals = torch.cat([torch.from_numpy(rng.randn(
            b, s * s, rtdetr.NH, dh).astype(np.float32)) for s in sizes],
            dim=1).to(device)
        q = torch.from_numpy(rng.randn(b, nq, rtdetr.HD).astype(
            np.float32)).to(device)
        refer = torch.sigmoid(torch.from_numpy(rng.randn(b, nq, 4).astype(
            np.float32))).to(device)
    ca = m.dec.layers[0].ca

    stages = {
        "stretch resize": lambda: resize_stretch_u8(frames,
                                                    size=args.imgsz),
        "backbone (HGNetv2-L)": lambda: m.backbone(x),
        "hybrid encoder (AIFI+CCFF)": lambda: m.enc(*taps),
        "decoder (deform layers)": lambda: m.dec(feats, nq,
                                                 det.decoder_layers),
        "deform attn (1 layer)": lambda: rtdetr.deform_attn(
            ca, q, refer, vals, shapes),
        "full forward (resize+model)": lambda: m(
            resize_stretch_u8(frames, size=args.imgsz), nq,
            det.decoder_layers),
    }

    def ms_of(fn) -> float:
        runs = [time_ms(fn, device, args.inner, args.inner)
                for _ in range(args.iters)]
        return float(np.median(runs))

    rows: Dict[str, dict] = {}
    with torch.inference_mode():
        for name, fn in stages.items():
            ms = ms_of(fn) / b
            fl = flops_of(fn) / b
            rows[name] = {"ms_per_frame": ms, "gflops_per_frame": fl / 1e9,
                          "tflops_achieved": fl / (ms / 1e3) / 1e12
                          if ms > 0 else 0.0}
            print(f"[rtdetr] {name:28s} {ms:8.3f} ms/frame  "
                  f"{fl / 1e9:8.2f} GFLOPs/frame  "
                  f"{rows[name]['tflops_achieved']:7.3f} TFLOP/s",
                  flush=True)

        # the decoder: launches against gather bytes, both formulations
        dec = stages["decoder (deform layers)"]
        split = {"queries": nq, "layers": layers, "batch": b,
                 "bf16_vals": bool(rtdetr._BF16_VALS),
                 **launches_of(dec, device),
                 **gather_bytes(b, nq, layers, rtdetr._BF16_VALS)}
        saved = rtdetr._PAIRED_GATHERS
        try:
            for paired in (False, True):
                rtdetr._PAIRED_GATHERS = paired
                split[f"ms_paired_gathers_{int(paired)}"] = ms_of(dec)
                split[f"launches_paired_gathers_{int(paired)}"] = \
                    launches_of(dec, device)["kernel_launches"]
        finally:
            rtdetr._PAIRED_GATHERS = saved
    ms_dec = split[f"ms_paired_gathers_{int(saved)}"]
    split["ms"] = ms_dec
    if split["kernel_launches"]:
        split["us_per_launch"] = ms_dec * 1e3 / split["kernel_launches"]
    split["gather_share_at_hbm"] = split["ms_at_hbm"] / ms_dec \
        if ms_dec > 0 else 0.0
    print(f"[rtdetr] decoder split: {ms_dec:.3f} ms a batch of {b}; "
          f"{split['kernel_launches']} kernel launches "
          f"({split['aten_ops']} aten ops); gathers "
          f"{(split['value_bytes'] + split['index_bytes']) / 1e6:.1f} MB "
          f"= {split['ms_at_hbm']:.4f} ms at 3.35 TB/s "
          f"({100 * split['gather_share_at_hbm']:.2f} % of the decoder); "
          f"paired gathers 0 / 1: {split['ms_paired_gathers_0']:.3f} / "
          f"{split['ms_paired_gathers_1']:.3f} ms, "
          f"{split['launches_paired_gathers_0']} / "
          f"{split['launches_paired_gathers_1']} launches ({card})",
          flush=True)

    total = sum(rows[k]["ms_per_frame"] for k in (
        "stretch resize", "backbone (HGNetv2-L)",
        "hybrid encoder (AIFI+CCFF)", "decoder (deform layers)"))
    full = rows["full forward (resize+model)"]
    print(f"[rtdetr] stage sum {total:.3f} ms vs full forward "
          f"{full['ms_per_frame']:.3f} ms ({full['gflops_per_frame']:.2f} "
          f"GFLOPs/frame)", flush=True)
    peak = PEAK_FLOPS[args.dtype]
    roofline = {}
    if device.type != "cuda":
        print("[rtdetr] roofline: not measured (no card)", flush=True)
        stages_of_roofline = ()
    else:
        stages_of_roofline = (("backbone", "backbone (HGNetv2-L)"),
                              ("encoder", "hybrid encoder (AIFI+CCFF)"),
                              ("decoder", "decoder (deform layers)"))
    for name, key in stages_of_roofline:
        fl = rows[key]["gflops_per_frame"] * 1e9
        floor = fl / peak * 1e3
        roofline[name] = {"floor_ms_per_frame": floor,
                          "share_of_peak": floor / rows[key]["ms_per_frame"]
                          if rows[key]["ms_per_frame"] > 0 else 0.0}
        print(f"[rtdetr] roofline {name}: {fl / 1e9:.1f} GFLOPs/frame at "
              f"{rows[key]['tflops_achieved']:.3f} TFLOP/s achieved; at "
              f"the H100's {peak / 1e12:g} {args.dtype} TFLOP/s this "
              f"stage's floor is {floor:.4f} ms/frame "
              f"({100 * roofline[name]['share_of_peak']:.2f} % of peak; "
              f"{card})", flush=True)
    return {"card": card, "stages": rows, "decoder_split": split,
            "roofline": roofline, "dtype": args.dtype, "res": h,
            "batch": b, "imgsz": args.imgsz}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=720)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "int8"])
    ap.add_argument("--inner", type=int, default=8,
                    help="calls chained between the two timing events")
    ap.add_argument("--iters", type=int, default=2,
                    help="timed repetitions (the median is kept)")
    ap.add_argument("--weights", default="rtdetr-l.pt",
                    help="an RT-DETR checkpoint (random init if absent)")
    ap.add_argument("--out", default=None, help="write the result as JSON")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; raises without one) or the "
                         "plain PyTorch path on the CPU")
    args = ap.parse_args(argv)
    out = run(args)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
        print(f"[rtdetr] wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
