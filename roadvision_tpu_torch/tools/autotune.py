"""Re-measure every pinned tuning choice of the port in one command — the
port of ``tools/autotune.py``.

    python -m roadvision_tpu_torch.tools.autotune [--res 1080] [--iters 8]
        [--quick] [--sweeps clahe_chunk,batch,...] [--out A.json]
        [--timeout 1800] [--tie-pct 2] [--redecide REPORT]
        [--device cuda|cpu]

Several of the port's settings are pinned to what one card measured:
K2's rows per block (``ops/clahe.py::APPLY_CHUNK_ROWS``, env
``RVT_CLAHE_CHUNK``), the engine batch, the detector's compute dtype,
the sampled preprocess, the temporal gate's coast budget and RT-DETR's
query count, decoder depth, value dtype and gather formulation. Each
trial runs ``python -m roadvision_tpu_torch.tools.bench`` in a
subprocess with the knob set by a flag or an environment variable (a
fresh process, so knobs read at import take effect), parses its JSON
line and keeps its ``value`` (frames/s), its launches of the
hand-written kernels a batch, and the batches those were counted over.
The winner of a sweep is the fastest trial, except that the pinned
value wins any tie: a candidate must beat it by more than ``--tie-pct``
percent. Advisory sweeps (accuracy- or staleness-trading knobs) report a
winner but never enter the recommendation.

The JAX tool's sweeps of XLA or Pallas choices that the port does not
have (``hist_dtype``, ``clahe_sweep``, ``median_impl``) stay in the
report as ``"not_applicable"`` with the reason, and so does
``rtdetr_gathers`` on the card, where K7 samples whatever the variable
says (on the CPU the plain version's two formulations are still
swept). ``--quick`` runs small
shapes and few iterations: it smokes the harness, its winners do not
transfer. Nothing is written unless ``--out`` names a file.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

from ..config import project_root

RTDETR = ("--model", "rtdetr-l.pt", "--res", "720")

# sweep name -> bench mode, the knob (a bench flag or an environment
# variable), candidate values, the pinned value, where a winner lands
# (("env", var) or ("config", dotted key)), extra bench arguments
SWEEPS: Dict[str, dict] = {
    "clahe_chunk": dict(
        mode="preprocess", var="RVT_CLAHE_CHUNK",
        values=["8", "16", "24", "48", "96"], pinned="24",
        target=("env", "RVT_CLAHE_CHUNK"),
        note="K2's rows per block (ops/clahe.py::APPLY_CHUNK_ROWS); "
             "every size gives the same bytes"),
    "sampled_preprocess": dict(
        mode="full", var="RVT_BENCH_SAMPLED", values=["0", "1"],
        pinned="0", target=("config", "tpu.sampled_preprocess")),
    "conv_dtype": dict(
        mode="detect", flag="--dtype",
        values=["bfloat16", "int8", "int8-static"], pinned="bfloat16",
        target=("config", "detect.compute_dtype"),
        note="int8-static = int8 with static activation scales from the "
             "first 16 frames (detect.int8_calibration)"),
    "batch": dict(
        mode="full", flag="--batch", values=["8", "16"], pinned="8",
        target=("config", "tpu.batch_size")),
    "rtdetr_nq": dict(
        mode="detect", var="RVT_BENCH_NQ", values=["100", "200", "300"],
        pinned="100", target=("config", "detect.num_queries"),
        args=RTDETR,
        note="rtdetr only: decode the top-N encoder proposals (default "
             "max(100, max_det))"),
    "rtdetr_gathers": dict(
        mode="detect", var="RVT_RTDETR_PAIRED_GATHERS", values=["0", "1"],
        pinned="0", target=("env", "RVT_RTDETR_PAIRED_GATHERS"),
        args=RTDETR,
        note="1 takes the 4 corner gathers of a level in one gather "
             "(12 -> 3 a layer; the same outputs)"),
    "rtdetr_val_dtype": dict(
        mode="detect", var="RVT_RTDETR_BF16_VALS", values=["0", "1"],
        pinned="1", target=("env", "RVT_RTDETR_BF16_VALS"), args=RTDETR,
        note="1 gathers bf16 values (f32 accumulation), half the gather "
             "bytes; 0 = f32 parity"),
    "rtdetr_decl": dict(
        mode="detect", var="RVT_BENCH_DECL", values=["3", "6"],
        pinned="6", target=("config", "detect.decoder_layers"),
        args=RTDETR, advisory=True,
        note="first-K decoder layers (early exit through layer K's "
             "heads). ADVISORY: trades box quality for frames/s, which "
             "the argmax cannot see; never recommended"),
    "gate_skip": dict(
        mode="gate", var="RVT_BENCH_GATE_SKIP", values=["3", "7", "15"],
        pinned="7",
        target=("config", "detect.temporal_gate.max_skip_batches"),
        advisory=True,
        note="coast budget: more skipped forwards on static scenes, older "
             "reused detections. ADVISORY: a staleness trade the argmax "
             "cannot see; never recommended"),
}

# the JAX tool's sweeps with no counterpart in the port
NOT_APPLICABLE = {
    "hist_dtype": "the TPU histogram's one-hot dtype (bf16 / int8 MXU "
                  "products); K1 counts with shared-memory atomics and has "
                  "no such choice",
    "clahe_sweep": "XLA or Pallas for the CLAHE LUT sweep; the port has "
                   "one route, K2 (csrc/clahe.cu), with no sweep",
    "median_impl": "XLA or Pallas for the 3x3 median (RVT_PALLAS); the "
                   "port has one route, K3 (csrc/median.cu)",
}
# sweeps that the card's route makes moot (on the CPU they still run)
CARD_NOT_APPLICABLE = {
    "rtdetr_gathers": "RVT_RTDETR_PAIRED_GATHERS picks one of the plain "
                      "version's two gather formulations; on the card K7 "
                      "(csrc/deform.cu) computes their one function in one "
                      "launch, whatever the variable says",
}
INT_KEYS = ("tpu.batch_size", "detect.num_queries", "detect.decoder_layers",
            "detect.temporal_gate.max_skip_batches")


def run_trial(sweep: dict, value: str, res: int, iters: int, windows: int,
              timeout: float, device: str) -> dict:
    """One bench subprocess → {"fps", "seconds", and "launches_per_batch"
    with "batches" or "error"}. A sweep's own ``args`` come after the
    common ones and win (the RT-DETR sweeps' ``--res 720``)."""
    cmd = [sys.executable, "-m", "roadvision_tpu_torch.tools.bench",
           "--mode", sweep["mode"], "--res", str(res), "--iters", str(iters),
           "--windows", str(windows), "--device", device,
           *sweep.get("args", ())]
    env = dict(os.environ)
    if "flag" in sweep:
        cmd += [sweep["flag"], value]
    else:
        env[sweep["var"]] = value
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=timeout, cwd=str(project_root()))
    except subprocess.TimeoutExpired:
        return {"fps": None, "seconds": time.perf_counter() - t0,
                "error": "timeout"}
    dt = time.perf_counter() - t0
    tail = (proc.stderr or "").strip().splitlines()[-1:] or [""]
    if proc.returncode != 0:
        return {"fps": None, "seconds": dt,
                "error": f"rc={proc.returncode}: {tail[0][:200]}"}
    for line in reversed((proc.stdout or "").splitlines()):
        try:
            rec = json.loads(line)
            fps = float(rec["value"])
        except (ValueError, KeyError, TypeError):
            continue
        out = {"fps": fps, "seconds": dt}
        if "launches_per_batch" in rec:
            out["launches_per_batch"] = rec["launches_per_batch"]
            out["batches"] = int(rec["iters"]) * int(rec["windows"])
        return out
    return {"fps": None, "seconds": dt,
            "error": "no JSON line in bench output"}


def set_dotted(d: dict, key: str, value) -> None:
    parts = key.split(".")
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = value


def decide(name: str, trials: dict, tie_pct: float) -> dict:
    """The winner of {value: {fps, ...}}: the fastest, unless the pinned
    value is within ``tie_pct`` percent of it."""
    sw = SWEEPS[name]
    ok = {v: t["fps"] for v, t in trials.items() if t.get("fps") is not None}
    knob = sw.get("flag") or sw["var"]
    entry = {"mode": sw["mode"], "knob": knob, "trials": trials,
             "pinned": sw["pinned"]}
    if "note" in sw:
        entry["note"] = sw["note"]
    if ok:
        entry["spread_pct"] = (max(ok.values()) - min(ok.values())) \
            / min(ok.values()) * 100.0
    if not ok:
        entry.update(winner=None, matches_pinned=None)
        return entry
    best = max(ok, key=ok.get)
    winner = best
    if sw["pinned"] in ok and best != sw["pinned"]:
        margin = (ok[best] - ok[sw["pinned"]]) / ok[sw["pinned"]] * 100.0
        if margin <= tie_pct:
            winner = sw["pinned"]
            entry["tie"] = {"best_measured": best,
                            "margin_pct": round(margin, 2),
                            "threshold_pct": tie_pct}
    entry.update(winner=winner, matches_pinned=winner == sw["pinned"])
    return entry


def recommend(report: dict) -> None:
    """report["recommended"] from the winners of the non-advisory sweeps."""
    rec = {"env": {}, "config": {}}
    for name, entry in report["sweeps"].items():
        winner = entry.get("winner")
        if name not in SWEEPS or winner is None \
                or SWEEPS[name].get("advisory"):
            continue
        kind, key = SWEEPS[name]["target"]
        if key == "detect.compute_dtype" and winner == "int8-static":
            set_dotted(rec["config"], "detect.compute_dtype", "int8")
            set_dotted(rec["config"], "detect.int8_calibration", 16)
            continue
        val = winner
        if key in INT_KEYS:
            val = int(winner)
        elif key == "tpu.sampled_preprocess":
            val = winner == "1"
        if kind == "env":
            rec["env"][key] = val
        else:
            set_dotted(rec["config"], key, val)
    report["recommended"] = rec


def not_applicable(names, device: str = "cpu") -> Dict[str, dict]:
    moot = {**NOT_APPLICABLE,
            **(CARD_NOT_APPLICABLE if device == "cuda" else {})}
    return {n: {"status": "not_applicable", "reason": moot[n]}
            for n in names if n in moot}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=8,
                    help="batches per timed window of each trial")
    ap.add_argument("--quick", action="store_true",
                    help="small shapes + few iterations (smoke the "
                         "harness, not a tuning run)")
    every = [*SWEEPS, *NOT_APPLICABLE]
    ap.add_argument("--sweeps", default=",".join(every),
                    help="comma list of sweeps to run (default: all)")
    ap.add_argument("--out", default=None, help="write the JSON report")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="per-trial subprocess timeout, seconds")
    ap.add_argument("--tie-pct", type=float, default=2.0,
                    help="a candidate must beat the pinned default by "
                         "more than this percent to displace it")
    ap.add_argument("--redecide", default=None, metavar="REPORT",
                    help="recompute winners and the recommendation from "
                         "an existing report's trials (no measurement)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the bench trials run (the card by "
                         "default; a trial raises without one)")
    args = ap.parse_args(argv)
    windows = 3
    if args.quick:
        args.res, args.iters, windows = 480, 2, 1

    if args.redecide:
        prior = json.loads(Path(args.redecide).read_text())
        report = {"res": prior.get("res"), "iters": prior.get("iters"),
                  "tie_pct": args.tie_pct, "sweeps": {}}
        for name, entry in prior["sweeps"].items():
            report["sweeps"][name] = entry \
                if entry.get("status") == "not_applicable" \
                else decide(name, entry["trials"], args.tie_pct)
        recommend(report)
    else:
        names = [s.strip() for s in args.sweeps.split(",") if s.strip()]
        unknown = [n for n in names if n not in every]
        if unknown:
            ap.error(f"unknown sweeps {unknown}; available: {every}")
        report = {"res": args.res, "iters": args.iters, "windows": windows,
                  "tie_pct": args.tie_pct, "device": args.device,
                  "methodology": "each trial one process of the port "
                                 "bench; its value is the median "
                                 "device-resident (or the mode's) "
                                 "frames/s over the windows",
                  "sweeps": not_applicable(names, args.device)}
        for name in names:
            if name in report["sweeps"]:
                continue
            sw = SWEEPS[name]
            knob = sw.get("flag") or sw["var"]
            trials = {}
            for value in sw["values"]:
                print(f"[autotune] {name}: {knob}={value} "
                      f"(mode={sw['mode']}) ...", file=sys.stderr,
                      flush=True)
                trials[value] = run_trial(sw, value, args.res, args.iters,
                                          windows, args.timeout, args.device)
                t = trials[value]
                print(f"[autotune]   -> {t['fps'] if t['fps'] is not None else t['error']} "
                      f"({t['seconds']:.0f}s)", file=sys.stderr, flush=True)
            report["sweeps"][name] = decide(name, trials, args.tie_pct)
        recommend(report)

    if args.quick:
        report["smoke"] = True
    out = json.dumps(report, indent=2)
    print(out)
    if args.out:
        Path(args.out).write_text(out + "\n")
        print(f"[autotune] wrote {args.out}", file=sys.stderr)
    changed = [n for n, s in report["sweeps"].items()
               if s.get("winner") is not None and not s["matches_pinned"]]
    if args.quick and changed:
        print("[autotune] QUICK-MODE smoke at small shapes: winners do "
              "not transfer to the deployment resolution; re-run without "
              "--quick before applying anything", file=sys.stderr)
    elif changed:
        print(f"[autotune] winners differ from pinned defaults for: "
              f"{', '.join(changed)}; see the recommended section",
              file=sys.stderr)
    else:
        print("[autotune] all winners match the pinned defaults",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
