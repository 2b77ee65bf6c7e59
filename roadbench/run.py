"""The benchmark of ``roadvision_tpu_torch``'s camera fleet: one run of
one cell, printed as one JSON line.

    python3 -m roadbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Reads the cell from ``BENCHMARK.json`` and the files it names, renders
its cameras' clips on the card from ``--seed``, builds the fleet engine
with the configuration's checkpoint, warms up the cell's one fleet
shape, measures for ``--seconds`` and judges what the window produced
against the plain reference. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (a stretch of the window
under ``torch.profiler``). The last lines on standard error, and the
``checks`` key of the result, give each number compared beside its
limit. ``--control 1`` runs the precision below the configuration's in
the program's place: the program's own int8 detector path, and the
reference tracker in bfloat16 for the program's float32 one. It has to
come out not correct; the benchmark's own runs never run it.

Exits non-zero, printing no result, without a card (or with fewer than
the cell asks for), or when JAX or the JAX package has been loaded.
Every cache the program builds stays in this checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from contextlib import ExitStack  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "roadbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "roadbench"
                                         / "torch_extensions")

FORBIDDEN = ("jax", "jaxlib", "flax", "roadvision_tpu")
PROFILE_SECONDS = 1.5     # the traced stretch: the window's last seconds
CONTROL = {"tpu": {"compute_dtype": "int8"}}


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _reader(metric: str, root: Path):
    path = root / "roadbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "roadbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Tracer:
    """Opens the profiler ``start`` seconds into the window and closes it
    at ``stop`` seconds (or when the loop ends). The process's first
    profiler start takes seconds (the device tracing library's set-up),
    so :meth:`warm` pays for it before the window."""

    def __init__(self, start: float, stop: float, on_open=None):
        self.start, self.stop = start, stop
        self.on_open = on_open
        self.stack = ExitStack()
        self.box = None
        self.opened_at: Optional[float] = None

    @staticmethod
    def warm() -> None:
        from .trace import traced
        with traced():
            pass

    def tick(self, elapsed: float) -> None:
        from .trace import traced
        if self.box is None and elapsed >= self.start:
            self.opened_at = time.perf_counter()
            if self.on_open is not None:
                self.on_open()
            self.box = self.stack.enter_context(traced())
        elif elapsed >= self.stop:
            self.close()

    def close(self) -> None:
        self.stack.close()

    @property
    def profile(self):
        return None if self.box is None else self.box[0]


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device=None, root: Path = ROOT,
             control: bool = False) -> Dict[str, Any]:
    """One run of cell ``name`` → the result line (a dict). ``device``
    defaults to the first card; tests pass the CPU. ``control`` runs the
    control in the program's place (see the module's docstring)."""
    import numpy as np
    import torch

    from . import check, harness
    from .spec import load_cell
    device = torch.device("cuda", 0) if device is None else device
    on_card = device.type == "cuda"
    cell = load_cell(name, root)
    phases = {"imports": time.perf_counter() - T_START}
    if on_card:
        # the program's CUDA libraries, built into the checkout on its
        # first run (keyed by their sources), loaded from there after
        from roadvision_tpu_torch.kernels import build_all
        t_build = time.perf_counter()
        build_all()
        phases["build"] = time.perf_counter() - t_build
    fleet = harness.Fleet(cell, seed, device, CONTROL if control else None)
    phases.update(fleet.setup_times)
    t_warm = time.perf_counter()
    fleet.warm_up()
    phases["warm_up"] = time.perf_counter() - t_warm
    # set-up without the build: a checkout's first run compiles, the
    # others find the libraries built
    setup_s = time.perf_counter() - T_START - phases.get("build", 0.0)
    print("[setup] " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
          + f"; setup_s {setup_s:.3f} s (the build left out)",
          file=sys.stderr)

    t = cell.traffic
    stage = fleet.engine.timer

    def timer_now():
        return {k: (v, stage.count[k]) for k, v in stage.total.items()}

    # the engine's stage timer over the window (its untraced part in a
    # traced run: the profiler slows the host)
    timer0, timer1 = timer_now(), {}
    tracer = None
    if trace and on_card:
        tracer = Tracer(max(seconds - PROFILE_SECONDS, seconds * 0.5),
                        seconds, on_open=lambda: timer1.update(timer_now()))
        tracer.warm()
    tick = tracer.tick if tracer else None
    if t["loop"] == "closed":
        win = harness.closed_loop(fleet, seconds, int(t["in_flight"]), tick)
    else:
        win = harness.open_loop(fleet, seconds, int(t["max_in_flight"]),
                                tick)
    if tracer:
        tracer.close()
    if on_card:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    frames_per_batch = cell.streams * cell.batch
    attempted = len(win.results) * frames_per_batch
    failed = sum(r is None for r in win.results) * frames_per_batch
    timer = {k: (v - timer0.get(k, (0.0, 0))[0], n - timer0.get(k, (0, 0))[1])
             for k, (v, n) in (timer1 or timer_now()).items()}

    dev: Dict[str, Any] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1 if on_card else 0, "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {}
    run = None
    if trace:
        run = harness.Run(cell, fleet.engine, fleet.pool, device, win, timer,
                          root=root)
        if tracer is not None and tracer.profile is not None:
            prof = run.profile = tracer.profile
            run.traced_from = tracer.opened_at
            untraced = tracer.opened_at - win.t0
            run.batches_per_s_untraced = sum(
                1 for d in win.done
                if d is not None and d < tracer.opened_at) / untraced
            dev.update(busy_s=prof.busy_s, window_s=prof.window_s)
            out["breakdown"] = {"device_ops": prof.top_ops(10),
                                "idle_gaps": prof.idle_gaps(10)}
        metrics = {}
        for m in cell.per_layer:
            value = _reader(m["name"], root)(run) if on_card else None
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        e2e = harness.end_to_end(cell, win)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}

    # the judgement, with the program's state freed: every frame of a
    # sample of the cameras, drawn from the seed
    readings: Dict[str, float] = {}
    if failed == 0:
        chk = cell.config["check"]
        cams = check.sample_cameras(seed, cell.streams, int(chk["cameras"]))
        out_arrays = check.pack(win.results, cams, cell.batch,
                                int(cell.config["pipeline"]["detect"]
                                    ["max_det"]))
        t0 = float(np.min(win.stamps[0]))
        stamps = np.concatenate(win.stamps, axis=1)[cams]
        slots = fleet.engine.engine.track_slots
        v = out_arrays["valid"]
        ids = out_arrays["ids"][v]
        traffic = (f"[traffic] {stamps.shape[1]} frames a camera in the "
                   f"window; {v.sum(axis=2).mean():.2f} detections a frame; "
                   f"{len(np.unique(ids[ids > 0]))} track ids in "
                   f"{len(cams)} cameras; camera pool "
                   f"{fleet.pool.numel() / 2**30:.2f} GiB")
        fleet.engine = run = None
        if on_card:
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        h, w = int(t["height"]), int(t["width"])
        ts = (stamps - t0).astype(np.float32)
        if control:
            out_arrays["ids"], out_arrays["dist"], out_arrays["speed"], _ = \
                check.replay(out_arrays, ts, cell.config, slots, h, w,
                             low=True)
        tracked, ref = check.judge_tracker(out_arrays, ts, cell.config,
                                           slots, h, w)
        readings.update(tracked)
        print(f"{traffic}; reference tracker: live tracks a camera "
              f"{ref.live_sum / max(ref.steps, 1):.1f} mean, {ref.live_max} "
              f"most of {slots} slots, {ref.dropped} new tracks dropped "
              f"for want of a slot", file=sys.stderr)
        picks = check.sample_frames(seed, len(cams), stamps.shape[1],
                                    int(chk["frames"]))
        readings.update(check.judge_detector(
            out_arrays, picks,
            lambda part: torch.stack([fleet.pool[cams[s], f % fleet.clip]
                                      for s, f in part]),
            cell.config, device, root))
    limits = cell.config["check"]["limits"]
    correct = failed == 0 and all(readings[k] <= limits[k] for k in limits)
    out.update({"correct": bool(correct), "attempted": attempted,
                "failed": failed, "metrics": metrics, "device": dev,
                "checks": {k: {"value": readings.get(k), "limit": limits[k]}
                           for k in limits}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(entry["chips"]):
        print(f"the cell needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace),
                      control=bool(args.control))
    found = loaded_forbidden()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    result["checks"] = result.pop("checks")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
